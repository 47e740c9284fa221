"""Mini-batch k-means: fits the syllable-token codebooks.

Port of ``sylber_tpu/flow/kmeans.py``: k-means++ seeding from a pool of at
most 65,536 points, then mini-batch Lloyd updates with per-cluster rates
1/count, and between epochs the re-seeding of clusters no point of a fixed
subsample chose, drawn by distance from that subsample.

- :func:`_assign` and :func:`_minibatch_update` are torch ops at full fp32
  (TF32 off under ``matmul_precision("highest")``, as the quantizer's
  search); the batch sums are the one-hot matmul JAX takes.
- :func:`fit_kmeans` keeps JAX's host ``RandomState(seed)`` calls in their
  order (the seed pool, the subsample, each epoch's permutation, the
  re-seeding), so everything but the seeding's own draws is the same
  stream.
- The seeding, :func:`kmeanspp`, is the hand-written kernel of
  ``csrc/kmeanspp.cu`` on a CUDA tensor (one persistent cooperative launch a
  seeding; its header says what bounds it and how the design answers that)
  and :func:`kmeanspp_plain` on a CPU tensor. The kernel takes any width up
  to ``MAX_WIDTH`` (past about 57,000 floats its center is read through L2
  instead of shared memory) and about 2.5 million rows on an H100; it
  raises a ``ValueError`` before the launch for a shape past that
  (:func:`seeding_refusal`). Both make the same inverse-CDF draws from k
  float64 uniforms (a ``torch.Generator`` seeded with ``seed``, where JAX
  draws a Gumbel-max categorical from a ``PRNGKey``), the plain version one
  step at a time with ``torch.cumsum`` and ``searchsorted``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import check, device_of, lib, require_cuda, stream_of
from ..models.hubert import matmul_precision

MIN_WEIGHT = 1e-30  # the floor of a squared distance as a draw's weight (JAX's)
# the seeding kernel's launch: the fewest rows a block owns (a small pool
# takes a small grid, and with it a cheaper exchange) and a block's most
# threads
MIN_ROWS_PER_BLOCK = 64
MAX_THREADS = 1024
MAX_WIDTH = 1 << 29  # csrc/kmeanspp.cu: the scratch counts its words in int


def kmeanspp_plain(x: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means++ seeding of ``x`` (n, d) fp32 from the uniforms ``u`` (k,)
    float64: ``(centers (k, d), rows (k,) int64)``. Center 0 is row
    ``floor(u[0] n)``; center j the first row whose float64 prefix sum of
    ``max(d2, 1e-30)`` exceeds ``u[j]`` times the total, with ``d2`` the
    running minimum of the squared distances to the centers so far, summed
    over differences. No step reads the device from the host."""
    n = x.shape[0]
    k = u.shape[0]
    u = u.to(x.device, torch.float64)
    rows = torch.empty(k, dtype=torch.int64, device=x.device)
    idx = torch.clamp_max(torch.floor(u[:1] * n).long(), n - 1)
    rows[:1] = idx
    d2 = None
    for j in range(1, k):
        dist = ((x - x.index_select(0, idx)) ** 2).sum(-1)
        d2 = dist if d2 is None else torch.minimum(d2, dist)
        cum = torch.cumsum(d2.clamp_min(MIN_WEIGHT).double(), 0)
        idx = torch.searchsorted(cum, u[j:j + 1] * cum[-1:], right=True).clamp_max(n - 1)
        rows[j:j + 1] = idx
    return x.index_select(0, rows), rows


def _row_stride(d: int) -> int:
    return (d + 3) // 4 * 4


def seeding_refusal(n: int, d: int, sms: int, optin_bytes: int,
                    min_rows: int = MIN_ROWS_PER_BLOCK) -> Optional[str]:
    """Why the seeding kernel cannot take ``n`` rows of width ``d`` on a card
    of ``sms`` SMs with ``optin_bytes`` of shared memory a block, or None:
    the width past ``MAX_WIDTH``, or a block's fixed part of shared memory
    (``csrc/kmeanspp.cu``'s ``Layout`` without the center: its scratch, the
    words of exchange 1, the slice's float64 prefix and float32 d2) past
    ``optin_bytes`` on the first grid the plan tries."""
    if d > MAX_WIDTH:
        return f"a width of {d} is past the kernel's {MAX_WIDTH}"
    grid = min(sms, -(-n // min_rows))
    rows = -(-n // grid)
    grid = -(-n // rows)
    fixed = 16 * 32 + 32 + 4 * _row_stride(2 * grid) + 12 * _row_stride(rows)
    if fixed > optin_bytes:
        return (f"{n} rows take {rows} a block on {grid} blocks, whose weights need {fixed} "
                f"bytes of shared memory a block, past the card's {optin_bytes}")
    return None


def kmeanspp(x: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kmeanspp_plain`'s function: the kernel on a CUDA tensor (one
    cooperative launch, nothing read back), the plain version on a CPU
    tensor. Raises a ``ValueError`` before the launch for a shape the
    kernel cannot take (:func:`seeding_refusal`)."""
    if x.device.type == "cpu":
        return kmeanspp_plain(x, u)
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"kmeanspp: x must be (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    if u.ndim != 1 or u.numel() < 1:
        raise ValueError("kmeanspp: u must hold one uniform a center")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads rows as float4
        x = x.clone()
    u = u.to(x.device, torch.float64).contiguous()
    require_cuda("kmeanspp", x, u)
    props = torch.cuda.get_device_properties(x.device)
    why = seeding_refusal(x.shape[0], x.shape[1], props.multi_processor_count,
                          props.shared_memory_per_block_optin)
    if why:
        raise ValueError(f"kmeanspp: the seeding kernel refuses x {tuple(x.shape)}: {why}")
    return _launch(x, u)


_PLAN_KEYS = ("grid", "rows_per_block", "resident_rows_per_block", "lanes_per_row", "smem_bytes",
              "threads", "shared_center")


def _plan(kl, n: int, d: int, min_rows: int, max_threads: int,
          capacity: int) -> Tuple[int, dict]:
    """The 8-byte words of scratch the kernel takes for n rows of width d on
    the current card, and its launch (``_PLAN_KEYS``); raises on a shape it
    refuses."""
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    size = kl.sylber_kmeanspp_scratch(n, d, min_rows, max_threads, capacity, plan)
    if size < 0:
        check(-size, "kmeanspp")
    return size, dict(zip(_PLAN_KEYS, plan))


def _launch(x: torch.Tensor, u: torch.Tensor, capacity: int = -1,
            min_rows: int = MIN_ROWS_PER_BLOCK,
            max_threads: int = MAX_THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on ``x`` (n, d) and ``u`` (k,): ``capacity`` resident rows
    a block (-1: as many as the card's shared memory holds)."""
    (n, d), k = x.shape, u.shape[0]
    kl = lib()
    with device_of(x):
        size, _ = _plan(kl, n, d, min_rows, max_threads, capacity)
        scratch = torch.zeros(size, dtype=torch.int64, device=x.device)
        rows = torch.empty(k, dtype=torch.int32, device=x.device)
        centers = torch.empty(k, d, dtype=torch.float32, device=x.device)
        check(kl.sylber_kmeanspp(x.data_ptr(), u.data_ptr(), scratch.data_ptr(), rows.data_ptr(),
                                 centers.data_ptr(), n, d, k, min_rows, max_threads, capacity,
                                 stream_of(x)), "kmeanspp")
    kmeanspp.launches += 1
    return centers, rows.long()


kmeanspp.launches = 0


def seeding_plan(n: int, d: int, device: Union[str, torch.device] = "cuda",
                 min_rows: int = MIN_ROWS_PER_BLOCK, max_threads: int = MAX_THREADS) -> dict:
    """The seeding kernel's launch for n rows of width d on a CUDA
    ``device``: ``_PLAN_KEYS``."""
    with torch.cuda.device(torch.device(device)):
        return _plan(lib(), n, d, min_rows, max_threads, -1)[1]


def kmeanspp_barrier_probe(n: int, d: int, steps: int, device: Union[str, torch.device] = "cuda",
                           min_rows: int = MIN_ROWS_PER_BLOCK,
                           max_threads: int = MAX_THREADS) -> None:
    """Enqueue ``steps`` of the kernel's exchange of every block's sum to
    every block, alone, on its grid for (n, d) on a CUDA ``device``: one
    cooperative launch, timed by the caller (the exchange's round trip, the
    unit of the kernel's chain bound)."""
    kl = lib()
    dev = torch.device(device)
    with torch.cuda.device(dev):
        size, _ = _plan(kl, n, d, min_rows, max_threads, -1)
        scratch = torch.zeros(size, dtype=torch.int64, device=dev)
        check(kl.sylber_kmeanspp_barrier_probe(scratch.data_ptr(), n, d, min_rows, max_threads,
                                               steps, torch.cuda.current_stream(dev).cuda_stream),
              "kmeanspp_barrier_probe")


def seeding_uniforms(seed: int, k: int) -> torch.Tensor:
    """The k float64 uniforms of a seeding, from a CPU generator seeded with
    ``seed`` (copied to the device once by the caller)."""
    return torch.rand(k, dtype=torch.float64, generator=torch.Generator().manual_seed(int(seed)))


def _kmeanspp_init(seed: int, x: torch.Tensor, k: int) -> torch.Tensor:
    """k centers of ``x`` by k-means++ seeding (JAX's ``_kmeanspp_init``,
    its key replaced by ``seed``)."""
    return kmeanspp(x, seeding_uniforms(seed, k).to(x.device))[0]


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by ``argmin(|c|^2 - 2 x.c)`` (the first on ties)."""
    dots = x @ centroids.T
    c2 = (centroids ** 2).sum(-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)


def _minibatch_update(centroids: torch.Tensor, counts: torch.Tensor, x: torch.Tensor):
    """One mini-batch Lloyd update with per-cluster rates 1/count:
    ``(centroids, counts, inertia)``, the inertia a 0-d device tensor."""
    idx = _assign(x, centroids)
    onehot = F.one_hot(idx, centroids.shape[0]).to(x.dtype)
    batch_counts = onehot.sum(0)
    batch_sums = onehot.T @ x
    new_counts = counts + batch_counts
    lr = batch_counts / torch.clamp_min(new_counts, 1.0)
    means = batch_sums / torch.clamp_min(batch_counts, 1.0)[:, None]
    new_centroids = torch.where((batch_counts > 0)[:, None],
                                centroids * (1 - lr[:, None]) + means * lr[:, None], centroids)
    inertia = ((x - new_centroids[idx]) ** 2).sum(-1).mean()
    return new_centroids, new_counts, inertia


def fit_kmeans(features: np.ndarray, n_clusters: int, batch_size: int = 16384,
               n_epochs: int = 10, seed: int = 0, normalize: bool = False,
               device: Union[None, str, torch.device] = None) -> Tuple[np.ndarray, float]:
    """features (N, d) -> (centroids (K, d), the last batch's inertia), on
    ``cuda`` unless ``device="cpu"``.

    ``normalize``: unit norm times 6 first, the quantizer's ``normalize``
    encoding. The features go to the device once; a batch is gathered there
    by index. The host reads the device once an epoch (the re-seeding needs
    the subsample's assignments and distances) and at the end."""
    from ..api import resolve_device

    device = resolve_device(device)
    x = np.asarray(features, np.float32)
    if normalize:
        x = x / (np.sqrt((x ** 2).sum(-1, keepdims=True) + 1e-8)) * 6.0
    n = len(x)
    if n < n_clusters:
        raise ValueError(f"fit_kmeans: {n} points for {n_clusters} clusters")
    rng = np.random.RandomState(seed)

    with matmul_precision("highest"):
        pool = torch.from_numpy(x[rng.choice(n, min(n, 65536), replace=False)]).to(device)
        centroids = _kmeanspp_init(seed, pool, n_clusters)
        del pool
        counts = torch.zeros(n_clusters, dtype=torch.float32, device=device)
        inertia = torch.tensor(float("inf"))
        sub_host = x[rng.choice(n, min(n, 65536), replace=False)]
        sub = torch.from_numpy(sub_host).to(device)
        x_dev = torch.from_numpy(x).to(device)
        for epoch in range(n_epochs):
            order = torch.from_numpy(rng.permutation(n)).to(device)
            for i in list(range(0, n - batch_size + 1, batch_size)) or [0]:
                batch = x_dev.index_select(0, order[i: i + batch_size])
                centroids, counts, inertia = _minibatch_update(centroids, counts, batch)
            if epoch < n_epochs - 1:
                # re-seed the clusters the subsample leaves empty from its
                # points, drawn by squared distance (JAX's host draws)
                idx_dev = _assign(sub, centroids)
                idx = idx_dev.cpu().numpy()
                dead = np.bincount(idx, minlength=n_clusters) == 0
                if dead.any():
                    d2 = ((sub - centroids[idx_dev]) ** 2).sum(-1).cpu().numpy()
                    p = d2 / max(d2.sum(), 1e-12)
                    reseed = rng.choice(len(sub_host), int(dead.sum()), replace=False, p=p)
                    dead_dev = torch.from_numpy(dead).to(device)
                    centroids = centroids.clone()
                    centroids[dead_dev] = torch.from_numpy(sub_host[reseed]).to(device)
                    counts = torch.where(dead_dev, 0.0, counts)
    return centroids.cpu().numpy(), float(inertia)
