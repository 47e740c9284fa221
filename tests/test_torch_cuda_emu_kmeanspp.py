"""The k-means++ seeding kernel's CUDA source (``kmeanspp.cu``: one
cooperative launch, the flag-word exchanges of ``common.cuh``) run on the CPU.

The sources are compiled by g++ against the host stand-in of
``tests/cuda_emu`` (``test_torch_cuda_emu.py``'s ``build_host_library``),
whose cooperative launch runs every block's threads at once on a card of 3
SMs, and driven through ``flow/kmeans.py``'s own launch code, against
``kmeanspp_plain`` on the same uniforms.

A separate file from ``test_torch_cuda_emu.py`` so that a distributed run can
give it a worker of its own.
"""

import ctypes

import numpy as np
import pytest
import torch

from sylber_tpu_torch.flow import kmeans as port_kmeans
from sylber_tpu_torch.kernels import _build
from test_torch_cuda_emu import _check, build_host_library
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, with the C entry points typed."""
    return build_host_library(tmp_path_factory.mktemp("cuda_emu"))


@pytest.fixture
def kmeanspp_launch(emulated, monkeypatch):
    """``flow/kmeans.py``'s launch code, bound to the host library."""
    monkeypatch.setattr(port_kmeans, "lib", lambda: emulated)
    monkeypatch.setattr(port_kmeans, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_kmeans, "check", _check)
    return port_kmeans._launch


KMEANSPP_CASES = [
    # name, rows, width, centers, distinct points (each repeated) or None, resident rows a
    # block (-1: all that fit), the fewest rows a block, a block's most threads; on the
    # stand-in's card of 3 SMs
    ("two-blocks", 128, 24, 24, None, -1, 64, 64),      # float4 loads, a grid of 2 blocks
    ("scalar-width", 128, 5, 16, None, -1, 64, 64),     # d % 4 != 0: rows padded in shared memory
    ("awkward-rows", 150, 144, 12, None, -1, 64, 128),  # 3 blocks of 50 rows
    ("duplicates", 128, 8, 16, 16, -1, 64, 64),         # 16 distinct points, 8 copies each
    ("partly-resident", 150, 24, 16, None, 20, 64, 64),    # 20 of a block's 50 rows resident
    ("none-resident-scalar", 128, 5, 16, None, 0, 64, 32),  # every row from memory, one warp
    ("d768-partly-resident", 96, 768, 8, None, 12, 32, 64),  # 3 blocks of 32 rows, 12 resident
    ("d768-resident", 96, 768, 8, None, -1, 32, 64),
    ("draw-in-last-block", 150, 24, 12, None, -1, 64, 64),  # the last block's rows far out
    ("grid-of-one", 20, 24, 20, None, -1, 64, 64),   # n below min_rows: one block, every row
    ("six-blocks", 384, 8, 12, None, -1, 64, 64),    # 2 blocks an SM: more blocks than SMs
]


@pytest.mark.parametrize("name,n,d,k,distinct,capacity,min_rows,max_threads", KMEANSPP_CASES,
                         ids=[c[0] for c in KMEANSPP_CASES])
def test_emulated_kmeanspp_matches_plain(kmeanspp_launch, emulated, name, n, d, k, distinct,
                                         capacity, min_rows, max_threads):
    """The seeding kernel (one cooperative launch: the distance update, the
    exchanges of flag words, the draw spread over the grid) against
    ``kmeanspp_plain`` on the same uniforms: the same rows and centers
    exactly (a row may differ only where the uniform lands within float64
    rounding of a prefix boundary; none does here), twice with the same rows,
    wholly and partly resident; on a pool of k distinct points each
    repeated, every distinct point once."""
    rng = np.random.RandomState(n + d + k)
    if distinct:
        pts = rng.randn(distinct, d).astype(np.float32)
        x = torch.from_numpy(pts[rng.permutation(np.repeat(np.arange(distinct), n // distinct))])
    else:
        x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    plan = (ctypes.c_int * len(port_kmeans._PLAN_KEYS))()
    assert emulated.sylber_kmeanspp_scratch(n, d, min_rows, max_threads, capacity, plan) > 0
    grid, rows_per_block, resident = plan[0], plan[1], plan[2]
    if name == "draw-in-last-block":
        x[(grid - 1) * rows_per_block:] *= 20
    u = port_kmeans.seeding_uniforms(n + k, k)
    assert port_kmeans.lib is not _build.lib
    centers, rows = kmeanspp_launch(x, u, capacity, min_rows, max_threads)
    again_centers, again = kmeanspp_launch(x, u, capacity, min_rows, max_threads)
    want_centers, want_rows = port_kmeans.kmeanspp_plain(x, u)
    np.testing.assert_array_equal(rows.numpy(), want_rows.numpy())
    torch.testing.assert_close(centers, want_centers, rtol=0, atol=0)
    np.testing.assert_array_equal(again.numpy(), rows.numpy())
    torch.testing.assert_close(again_centers, centers, rtol=0, atol=0)
    expect = {"grid-of-one": 1, "six-blocks": 6, "awkward-rows": 3, "two-blocks": 2}
    assert grid == expect.get(name, grid)
    assert resident == (min(capacity, rows_per_block) if capacity >= 0 else rows_per_block)
    if name == "draw-in-last-block":
        assert (rows[1:] >= (grid - 1) * rows_per_block).sum() >= k // 2
    if name == "grid-of-one":
        assert sorted(rows.tolist()) == list(range(n))
    if distinct:
        assert len({tuple(r) for r in centers.numpy().tolist()}) == distinct


@pytest.mark.parametrize("n,d,min_rows,grid", [(150, 24, 64, 3), (384, 8, 64, 6)],
                         ids=["3-blocks", "6-blocks"])
def test_emulated_exchange_reaches_every_block(emulated, n, d, min_rows, grid):
    """The exchange probe on the seeding's grid: 40 steps of every block's
    flag words to every block end with every block's words of the last
    step written (a block that read a word before its step would have taken
    a stale value; one that waited for a step never written would abort the
    stand-in); a capacity past the card's shared memory is refused."""
    plan = (ctypes.c_int * len(port_kmeans._PLAN_KEYS))()
    size = emulated.sylber_kmeanspp_scratch(n, d, min_rows, 64, -1, plan)
    stride = -(-d // 4) * 4
    assert plan[0] == grid and size == 2 * (2 * grid + stride)
    scratch = np.zeros(size, np.uint64)
    _check(emulated.sylber_kmeanspp_barrier_probe(scratch.ctypes.data, n, d, min_rows, 64, 40,
                                                  None), "kmeanspp_barrier_probe")
    last = scratch[: 2 * grid]  # step 40's parity: 0
    assert ((last >> np.uint64(32)) == 40).all()
    assert (scratch[size // 2: size // 2 + 2 * grid] >> np.uint64(32) == 39).all()
    assert emulated.sylber_kmeanspp_scratch(n, d, min_rows, 64, 10 ** 6, None) == -1
