"""Device mesh and sharding rules of the port (``sylber_tpu/parallel/mesh.py``).

One process per GPU, as torch runs data parallelism, where the JAX package
runs one process per host over all of its devices. A mesh has two axes,
``("dp", "mp")``, laid out row-major over the ranks of the world (rank
``r`` is dp index ``r // mp`` and mp index ``r % mp``, JAX's
``reshape(dp, mp)`` of the device list):

- ``dp``: data parallel. Every rank builds the same global batch and keeps
  its rows (:func:`shard_batch`); the gradients are averaged over ``dp``
  (one all-reduce of a flat buffer after the backward pass), or, for the
  leaves of JAX's FSDP plan, reduce-scattered by FSDP (``mesh: {fsdp:
  true}``, :func:`fully_shard_model`);
- ``mp``: tensor parallel over the encoder layers, written by hand
  (Megatron's layout, :data:`TP_RULES`): q/k/v and ``intermediate_dense``
  split by output rows, ``out_proj`` and ``output_dense`` by input columns,
  one all-reduce at the end of each sublayer (:class:`TensorParallel`).

A second kind of mesh holds replicas of a model on the devices of one
process (``make_mesh(devices=[...])``): the ``Segmenter``'s data-parallel
inference, as the JAX ``Segmenter`` puts its replicas on the devices of a
mesh.

Nothing here falls back to one device: a mesh larger than the world, a
``dp`` that does not divide the batch, or a ``distributed:`` block whose
process group cannot be formed raises.

JAX's ``replicated``, ``fetch_replicated`` and ``jnp_issubdtype_extended``
have no counterpart: a replicated leaf here is an ordinary tensor, whole on
each rank's device, and torch has no extended (PRNG key) dtype.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Collection, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# (regex over the port's state-dict name, spec of the leaf in the port's
# layout). First match wins; every other leaf is replicated. nn.Linear keeps
# its weight as (out, in), so JAX's column split P(None, "mp") of a (in, out)
# kernel is a split of dim 0 here.
TP_RULES = (
    (r"attention\.(q_proj|k_proj|v_proj)\.weight$", ("mp", None)),
    (r"attention\.(q_proj|k_proj|v_proj)\.bias$", ("mp",)),
    (r"attention\.out_proj\.weight$", (None, "mp")),
    (r"intermediate_dense\.weight$", ("mp", None)),
    (r"intermediate_dense\.bias$", ("mp",)),
    (r"output_dense\.weight$", (None, "mp")),
)

# Leaves smaller than this stay replicated in the FSDP plan: sharding a tiny
# bias saves nothing and costs a gather each use.
FSDP_MIN_SIZE = 2 ** 16

# How long a rank waits at the rendezvous and in each collective.
PROCESS_GROUP_TIMEOUT_S = 600.0

# The convolutions stay out of the FSDP plan, as in JAX (whose partitioner
# cannot shard a grouped conv's kernel on the batch's axis; they are under
# 5 % of HuBERT's parameters).
FSDP_EXCLUDE = re.compile(r"feature_extractor\.|pos_conv_embed\.")

Spec = Tuple[Optional[str], ...]


def tp_spec(name: str) -> Optional[Spec]:
    """The TP rule's spec of the leaf ``name``, or None (replicated)."""
    for pattern, spec in TP_RULES:
        if re.search(pattern, name):
            return spec
    return None


def tp_dim(name: str) -> Optional[int]:
    """The dim of ``name`` that tensor parallelism splits, or None."""
    spec = tp_spec(name)
    return None if spec is None else spec.index("mp")


def fsdp_leaf(name: str, shape, min_size: int = FSDP_MIN_SIZE) -> bool:
    """Whether FSDP may shard the whole leaf ``name`` of ``shape``: outside
    :data:`FSDP_EXCLUDE`, and of at least ``min_size`` elements."""
    n = 1
    for d in shape:
        n *= int(d)
    return len(shape) > 0 and n >= min_size and not FSDP_EXCLUDE.search(name)


def _fsdp_extend(spec: Spec, shape, dp: int, min_size: int = FSDP_MIN_SIZE) -> Spec:
    """Add ``"dp"`` to ``spec`` on the largest free dim that ``dp`` divides
    (the first of equal ones); leaves under ``min_size`` elements, or with
    no such dim, keep ``spec``."""
    n = 1
    for d in shape:
        n *= int(d)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    if n < min_size:
        return tuple(dims)
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if dims[i] is None and d % dp == 0 and d > best_size:
            best, best_size = i, int(d)
    if best is not None:
        dims[best] = "dp"
    return tuple(dims)


def hubert_param_specs(sd: Mapping[str, Any], use_tp: bool = True, fsdp_dp: int = 0,
                       fsdp_min_size: int = FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """The per-leaf plan of a ``HubertModel`` state dict: a tuple of axis
    names (``"mp"``, ``"dp"`` or None) per dim of each leaf, in the port's
    layout. ``fsdp_dp > 1`` adds the ``dp`` axis to every leaf of at least
    ``fsdp_min_size`` elements outside :data:`FSDP_EXCLUDE`, on the dim that
    JAX's ``_fsdp_extend`` picks in its layout: a Linear weight is
    considered as JAX's (in, out) kernel, so equal dims resolve as in JAX.

    This is the plan of JAX's ``hubert_param_specs``. FSDP
    (:func:`shard_params`) shards the leaves that :func:`fsdp_leaf` admits,
    on dim 0: the leaves given ``"dp"`` here, and any admitted leaf
    without a dim that ``dp`` divides (which FSDP2 pads)."""
    specs = {}
    for name, t in sd.items():
        shape = tuple(t.shape)
        spec = (tp_spec(name) if use_tp else None) or (None,) * len(shape)
        if fsdp_dp and fsdp_dp > 1 and fsdp_leaf(name, shape, fsdp_min_size):
            if len(shape) == 2 and name.endswith(".weight"):   # Linear (out, in)
                spec = _fsdp_extend(spec[::-1], shape[::-1], fsdp_dp, fsdp_min_size)[::-1]
            else:
                spec = _fsdp_extend(spec, shape, fsdp_dp, fsdp_min_size)
        specs[name] = tuple(spec)
    return specs


# ---- process group ----------------------------------------------------------

def _torchrun(env) -> bool:
    return "TORCHELASTIC_RUN_ID" in env or ("WORLD_SIZE" in env and "MASTER_ADDR" in env)


def local_rank() -> int:
    """The GPU index of this rank: torchrun's ``LOCAL_RANK``, else the rank
    modulo the visible devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = max(torch.cuda.device_count(), 1)
    return (dist.get_rank() if dist.is_initialized() else 0) % n


def maybe_distributed_init(dist_cfg: Optional[dict] = None, device=None) -> bool:
    """Join this process to the run's process group (``jax.distributed``'s
    counterpart). Returns True if this call formed the group.

    Enabled by a ``distributed:`` block (unless it says ``enabled: false``),
    ``SYLBER_TPU_DIST=1``, ``SYLBER_TPU_COORDINATOR`` or a torchrun launch.
    The rendezvous: ``coordinator_address`` (``SYLBER_TPU_COORDINATOR``) as
    ``host:port`` (TCP) or a ``file://`` path, else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``; the world and this process's place in
    it: ``num_processes`` / ``process_id`` (``SYLBER_TPU_NUM_PROCESSES`` /
    ``SYLBER_TPU_PROCESS_ID``, else torchrun's ``WORLD_SIZE`` / ``RANK``),
    counting ranks, one a GPU. NCCL on CUDA (the device ``cuda:LOCAL_RANK``),
    gloo where ``device`` is the CPU; :data:`PROCESS_GROUP_TIMEOUT_S` bounds
    the rendezvous and each collective. A second call does nothing; a group
    that cannot be formed raises."""
    if dist.is_initialized():
        return False
    cfg = dict(dist_cfg or {})
    env = os.environ
    enabled = bool(cfg.get("enabled", True)) if dist_cfg is not None else False
    enabled = (enabled or env.get("SYLBER_TPU_DIST") == "1"
               or "SYLBER_TPU_COORDINATOR" in env or _torchrun(env))
    if not enabled:
        return False
    addr = cfg.get("coordinator_address") or env.get("SYLBER_TPU_COORDINATOR")
    world = cfg.get("num_processes", env.get("SYLBER_TPU_NUM_PROCESSES", env.get("WORLD_SIZE")))
    rank = cfg.get("process_id", env.get("SYLBER_TPU_PROCESS_ID", env.get("RANK")))
    if world is None or rank is None:
        raise ValueError("a distributed run needs num_processes and process_id "
                         "(SYLBER_TPU_NUM_PROCESSES / SYLBER_TPU_PROCESS_ID, or torchrun's "
                         "WORLD_SIZE / RANK)")
    if addr:
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif "MASTER_ADDR" in env:
        init_method = "env://"
    else:
        raise ValueError("a distributed run needs a coordinator_address "
                         "(SYLBER_TPU_COORDINATOR) or torchrun's MASTER_ADDR")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sylber_tpu_torch runs on a CUDA device and none is "
                               "available; pass device='cpu' to run on the CPU")
        device_type = "cuda"
    else:
        device_type = torch.device(device).type
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", int(rank) % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank),
                            timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    return True


def is_main() -> bool:
    """Rank 0, or no process group: the process that writes the outputs."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---- meshes ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, mp)`` mesh: over the world's ranks (``device_mesh``, a torch
    ``DeviceMesh`` with dims ``("dp", "mp")``), or over replicas in this
    process (``devices``, dp only)."""
    dp: int
    mp: int
    devices: Tuple[torch.device, ...] = ()
    device_mesh: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def dp_rank(self) -> int:
        return self.device_mesh.get_local_rank("dp") if self.device_mesh is not None else 0

    @property
    def mp_rank(self) -> int:
        return self.device_mesh.get_local_rank("mp") if self.device_mesh is not None else 0


def make_mesh(dp: Optional[int] = None, mp: int = 1, devices: Optional[Sequence] = None,
              device_type: Optional[str] = None) -> Mesh:
    """A mesh of ``dp x mp``.

    With ``devices``: replicas in this process, one on each of the first
    ``dp`` devices listed (a device may repeat); ``mp`` must be 1. Without,
    under a process group: the world's ranks, ``dp`` (None or -1: the world
    over ``mp``) times ``mp`` of them, which must be all of them. Without a
    process group: replicas on the visible CUDA devices. A mesh larger than
    what exists raises."""
    if dp == -1:
        dp = None
    if devices is None and not dist.is_initialized():
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no process group and no CUDA device for a mesh; pass "
                               "devices=[...] (e.g. ['cpu', 'cpu']) for replicas on the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if mp != 1:
            raise ValueError("a mesh of replicas in one process is data parallel only (mp 1)")
        dp = len(devices) if dp is None else int(dp)
        if not 1 <= dp <= len(devices):
            raise ValueError(f"mesh dp={dp} exceeds the {len(devices)} devices given")
        return Mesh(dp, 1, tuple(devices[:dp]))
    world = dist.get_world_size()
    if dp is None:
        if world % mp:
            raise ValueError(f"mp={mp} does not divide the world of {world} ranks")
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} ranks; the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (dp, mp), mesh_dim_names=("dp", "mp"))
    return Mesh(dp, mp, device_mesh=dm)


def mesh_from_config(mesh_cfg: Optional[Mapping], device) -> Optional[Mesh]:
    """The world mesh a recipe's ``mesh: {dp, mp}`` asks for, or None for
    one process without a process group (which may ask for one device
    only: ``dp: -1 | 1``, ``mp: 1``)."""
    cfg = dict(mesh_cfg or {})
    mp = int(cfg.get("mp", 1))
    dp = cfg.get("dp", -1)
    dp = None if dp in (-1, None) else int(dp)
    if not dist.is_initialized():
        if (dp or 1) * mp > 1:
            raise ValueError(f"mesh dp={dp} mp={mp} needs {(dp or 1) * mp} ranks and this "
                             "process is alone: launch with torchrun, a distributed: block "
                             "or the SYLBER_TPU_* variables")
        return None
    return make_mesh(dp, mp, device_type=torch.device(device).type)


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows (its dp index's share of axis 0) of every tensor in
    ``batch`` (a tensor, a dict or a sequence of them; None passes). Raises
    when ``dp`` does not divide a batch."""
    if mesh is None or mesh.dp == 1:
        return batch

    def rows(x):
        if not torch.is_tensor(x):
            return x
        if x.shape[0] % mesh.dp:
            raise ValueError(f"dp={mesh.dp} does not divide the batch of {x.shape[0]}")
        b = x.shape[0] // mesh.dp
        return x[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]

    if isinstance(batch, Mapping):
        return {k: rows(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(rows(v) for v in batch)
    return rows(batch)


# ---- collectives -----------------------------------------------------------

def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (an FSDP leaf, sharded over dp)."""
    return hasattr(t, "to_local") and hasattr(t, "placements")


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of an FSDP (DTensor) leaf; any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The pieces of ``t`` of every rank of ``group``, concatenated on ``dim``
    in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, n: int) -> None:
    """Replace ``tensors`` by their mean over the ``n`` ranks of ``group``:
    one all-reduce of one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if n > 1:
        flat /= n
    torch._foreach_copy_(list(tensors), [p.view_as(t) for p, t in
                                         zip(flat.split([t.numel() for t in tensors]), tensors)])


def reduce_mean(metrics: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
                sums: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from each rank's batch means: their mean
    over dp in float32, but the counts named in ``sums`` summed, in their
    own dtype; one all-reduce. Without a mesh, ``metrics`` as they are."""
    if mesh is None:
        return dict(metrics)
    keys = list(metrics)
    both = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(both, group=mesh.group("dp"))
    return {k: both[i].to(metrics[k].dtype) if k in sums else both[i] / mesh.dp
            for i, k in enumerate(keys)}


def _unshard(t) -> torch.Tensor:
    """The whole tensor of an FSDP2 leaf (``Shard(0)`` over a 1-D mesh: rank
    r holds rows from r * ceil(n / world), as ``torch.chunk`` cuts them),
    by c10d's all-gather of the padded shards. Not ``full_tensor()``: its
    functional collective crashes over gloo on CUDA tensors (torch 2.11)."""
    group = t.device_mesh.get_group()
    world = dist.get_world_size(group)
    shard = t.to_local()
    rows = -(-t.shape[0] // world)
    padded = shard.new_zeros((rows,) + tuple(t.shape[1:]))
    padded[:shard.shape[0]] = shard
    out = shard.new_empty((rows * world,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:t.shape[0]]


def gather_full(t: torch.Tensor, name: str, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole leaf ``name`` on every rank: FSDP shards gathered over dp,
    then TP pieces over mp. All ranks call it together."""
    t = t.detach()
    if is_dtensor(t):
        t = _unshard(t)
    if mesh is not None and mesh.mp > 1:
        d = tp_dim(name)
        if d is not None:
            t = all_gather_cat(t, d, mesh.group("mp"))
    return t


def put_global(x: torch.Tensor, mesh: Mesh, spec: Spec) -> torch.Tensor:
    """This rank's piece of the whole tensor ``x`` (the same on every rank)
    under ``spec``: each dim named ``"mp"`` or ``"dp"`` cut into that
    axis's equal pieces (``torch.chunk``), the rank's kept; no
    communication."""
    for d, axis in enumerate(spec):
        if axis == "mp" and mesh.mp > 1:
            x = x.chunk(mesh.mp, d)[mesh.mp_rank]
        elif axis == "dp" and mesh.dp > 1:
            x = x.chunk(mesh.dp, d)[mesh.dp_rank]
    return x


def shard_like(full: torch.Tensor, name: str, mesh: Optional[Mesh], like: torch.Tensor):
    """This rank's piece of the whole leaf ``full``, laid out as ``like``
    (the live leaf): the TP piece, then the FSDP shard; no communication."""
    t = full if mesh is None else put_global(full, mesh, tp_spec(name) or ())
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(like.device, like.dtype), like.device_mesh,
                                 like.placements, src_data_rank=None)
    return t.to(like.device, like.dtype)


def fetch_global(sd: Mapping[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Whole leaves of a possibly sharded state dict, on the CPU, on every
    rank (``io/checkpoint.py::save_params_npz`` writes them in the JAX
    layout). All ranks call it together."""
    return {k: gather_full(v, k, mesh).cpu() for k, v in sd.items()}


# ---- tensor parallelism ----------------------------------------------------

class _EnterTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the mp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ExitTP(torch.autograd.Function):
    """The partial sums all-reduced over the mp group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's place in the mp group of an encoder sublayer: ``enter``
    at the sublayer's (replicated) input, ``exit`` on its partial output
    before the bias; each sublayer costs one all-reduce forward and one
    backward."""
    group: Any
    size: int
    rank: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterTP.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _ExitTP.apply(x, self.group)


def tensor_parallel(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Split a ``HubertModel``'s encoder layers over ``mesh``'s mp axis in
    place (:data:`TP_RULES`): each rank keeps its rows or columns of the
    split leaves and ``num_attention_heads / mp`` heads. Raises where mp
    does not divide the heads or ``intermediate_size``, and for the int8
    and fused-q/k/v serving forms (inference only, never sharded in JAX)."""
    cfg, mp = model.cfg, mesh.mp
    if mp == 1:
        return model
    if cfg.int8_encoder or cfg.fused_qkv:
        raise ValueError("int8_encoder and fused_qkv are inference forms; tensor parallelism "
                         "(mp > 1) is a training mode")
    if cfg.num_attention_heads % mp or cfg.intermediate_size % mp:
        raise ValueError(f"mp={mp} must divide the {cfg.num_attention_heads} heads and "
                         f"intermediate_size {cfg.intermediate_size}")
    tp = TensorParallel(mesh.group("mp"), mp, mesh.mp_rank)
    for layer in model.layers:
        for name, p in list(layer.named_parameters()):
            d = tp_dim(name)
            if d is None:
                continue
            owner, leaf = name.rsplit(".", 1)
            piece = p.detach().chunk(mp, d)[tp.rank].clone()
            setattr(layer.get_submodule(owner), leaf,
                    torch.nn.Parameter(piece, requires_grad=p.requires_grad))
        layer.tp = tp
        layer.attention.tp = tp
    return model


def shard_params(model: torch.nn.Module, mesh: Mesh, use_tp: bool = True,
                 fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE) -> torch.nn.Module:
    """A ``HubertModel`` laid out over ``mesh`` in place: split over mp
    (:func:`tensor_parallel`, with ``use_tp``), then, with ``fsdp``, the
    leaves of JAX's FSDP plan sharded over dp (:func:`fully_shard_model`;
    :func:`fsdp_leaf` decides on the whole leaves, before the split)."""
    whole = {n for n, p in model.named_parameters()
             if not fsdp_leaf(n, tuple(p.shape), fsdp_min_size)}
    if use_tp:
        tensor_parallel(model, mesh)
    if fsdp:
        fully_shard_model(model, mesh, whole)
    return model


def fully_shard_model(model: torch.nn.Module, mesh: Mesh,
                      whole: Collection[str] = ()) -> torch.nn.Module:
    """FSDP2 over the dp axis: each encoder layer a unit, the rest of the
    model the root's; every leaf but those named in ``whole`` sharded on
    dim 0 (JAX shards a leaf on its largest divisible dim, ``ROADMAP.md``
    section 3). The leaves in ``whole`` stay plain tensors, whole on every
    rank, and FSDP does not reduce their gradients: the train step
    all-reduces them. Composes with :func:`tensor_parallel` (apply that
    first): each mp index shards its pieces over its own dp group."""
    from torch.distributed.fsdp import fully_shard

    dp_mesh = mesh.device_mesh["dp"]
    kept = {p for n, p in model.named_parameters() if n in whole}
    for layer in model.layers:
        fully_shard(layer, mesh=dp_mesh, ignored_params=kept)
    fully_shard(model, mesh=dp_mesh, ignored_params=kept)
    return model
