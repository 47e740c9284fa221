"""Sylber self-distillation training step (stage 1 and stage 2).

Port of ``sylber_tpu/train/distill.py``. One step:

1. the EMA teacher update, at accumulation boundaries only (none at all
   for the frozen teacher, ``ema_decay: 1.0``, as in both recipes);
2. the teacher forward in eval mode under ``torch.no_grad()``, so it runs
   the hand-written kernels; fp32 output;
3. stage 1: the batch's segments; stage 2 (``segment_online``): the norm
   threshold from the thresholder as a 0-d device tensor, the segmentation
   kernels on the teacher's states, and the thresholder's stats updated on
   the device. The merge threshold is drawn on the host from the step's CPU
   generator (JAX draws it on the device) and copied into device memory
   with the step's learning rate before the step; the kernels read it from
   there, and nothing is read back;
4. optional segment-span masking and noise mixing of the student's input;
5. the student forward in train mode (dropouts, differentiable layer 0 and
   attention core, see ``models/hubert.py``) and torch autograd: the loss
   is the per-frame squared error to the segment-averaged teacher fill,
   summed over the width and averaged over frames;
6. AdamW (betas 0.9 / 0.95, eps 1e-4, weight decay 0.1) at the warmup-cosine
   learning rate of its update count, after the global-norm clip
   ``g * min(1, grad_clip / |g|)`` (optax's ``clip_by_global_norm``; torch's
   ``clip_grad_norm_`` adds 1e-6 to the norm), with ``optax.MultiSteps``
   accumulation: the mean of k micro-batch gradients applied every k steps.

Nothing in a step reads the device from the host: it returns its metrics
as device tensors. The step's randomness comes from generators seeded from
``(seed, step)`` (:func:`step_generators`; in the trainer the generators
of :class:`StepRandom`, made once per training state and reseeded before
each step), so a resumed run repeats an uninterrupted one. The state is
updated in place (the JAX step returns a new one), its thresholder, moments
and accumulators in the same tensors, so that a CUDA graph of the step
(``train/loop.py``'s ``steps_per_dispatch``) replays on them. Host values
that change from step to step reach the step as device memory: the merge
threshold and the learning rate in a (2,) float32 row (on CUDA AdamW is
``capturable`` and its rate a device tensor), the dropout seeds through the
reseeded generators; the host's branches on ``state.step`` (the EMA, the
accumulation window) are fixed for each position in the window.

Under a mesh (``parallel/mesh.py``; ``make_train_step(cfg, mesh)``) each
rank takes its rows of the global batch and the step is the global batch's:

- the span mask's and the noise mixer's draws are drawn for the global
  batch and sliced to the rank's rows (utterance mixing reads the global
  batch, gathered over ``dp``); the merge threshold is drawn on the host
  from ``(seed, step)``, the same on every rank. Dropout is the exception:
  each dp rank seeds its masks from ``(seed, step, rank)`` (``ROADMAP.md``
  section 3), as drawing the global masks would cost dp times the draws;
- the thresholder's sums and counts are all-reduced over ``dp``;
- the gradients are averaged over ``dp`` by one all-reduce of a flat buffer
  after the backward pass (FSDP reduce-scatters those of the leaves it
  shards itself), and the clip takes the norm of the reduced gradient over
  every shard;
- ``loss``, ``num_segments`` and ``masked_frames`` are reduced over ``dp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.device import _pinned, pcm_normalize
from ..data.noise import NoiseMixerConfig, mix_noise, mix_noise_apply, noise_draws
from ..models.hubert import (HubertConfig, HubertModel, feature_vector_attention_mask,
                             init_weights, matmul_precision)
from ..ops.segment import averaged_target_fill, segment_batch
from ..parallel.mesh import (FSDP_MIN_SIZE, Mesh, all_gather_cat, all_reduce_mean_, gather_full,
                             is_dtensor, local, reduce_mean, shard_batch, shard_like,
                             shard_params, tp_dim)
from ..ops.attention import DropoutStream
from .ema import ema_init, ema_update
from .lr import cosine_warmup_schedule
from .thresholder import ThresholderState, get_threshold, thresholder_init, update_stats


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    model: HubertConfig = HubertConfig()
    ema_decay: float = 1.0                     # frozen teacher, as both recipes
    ema_fp32_shadow: bool = True               # a float32 EMA whatever the student's dtype
    segment_online: bool = False
    merge_threshold_range: Tuple[float, float] = (0.5, 0.7)
    use_train_thrupdate: bool = False
    thresholder_decay: float = 0.9999
    mask_prob: float = 0.0
    min_mask_n: int = 0
    max_mask_set: int = 1
    do_noise_augment: bool = False
    noise_mixer: NoiseMixerConfig = NoiseMixerConfig()
    lr: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 200_000
    min_factor: float = 1.0
    hold_steps: int = 0
    weight_decay: float = 0.1
    grad_clip: float = 0.5
    loss_scale: float = 1.0
    accumulate_grad_batches: int = 1


@dataclasses.dataclass
class TrainState:
    step: int                         # micro-batches taken, a host count
    student: HubertModel
    teacher: HubertModel              # its tensors are the EMA parameters
    optimizer: torch.optim.AdamW
    thresholder: ThresholderState
    acc_grads: Optional[List[torch.Tensor]] = None  # MultiSteps mean gradient
    mesh: Optional[Mesh] = None       # the student, teacher and moments sharded over it
    rng: Optional["StepRandom"] = None  # the step's generators, reseeded each step

    @property
    def ema(self) -> Dict[str, torch.Tensor]:
        return self.teacher.state_dict()

    def state_dict(self) -> Dict[str, Any]:
        """The whole state; under a mesh every leaf gathered whole (all ranks
        call this together), so a checkpoint has one layout whatever the mesh."""
        if self.mesh is None:
            return dict(step=self.step, params=self.student.state_dict(),
                        ema=self.teacher.state_dict(),
                        optimizer=host_optimizer_state(self.optimizer),
                        thresholder=tuple(self.thresholder), acc_grads=self.acc_grads)
        names = [n for n, _ in self.student.named_parameters()]
        full = lambda sd: {k: gather_full(v, k, self.mesh).cpu() for k, v in sd.items()}  # noqa: E731
        # the moments keyed by the student's parameter order in one group
        # (the layout without a mesh), whatever groups the optimizer has
        order, pos = self._optimizer_names(), {n: i for i, n in enumerate(names)}
        opt = host_optimizer_state(self.optimizer)
        opt = dict(opt, param_groups=[dict(opt["param_groups"][0], params=list(range(len(names))))],
                   state={pos[order[i]]: {k: (gather_full(v, order[i], self.mesh).cpu()
                                              if k != "step" else v) for k, v in st.items()}
                          for i, st in opt["state"].items()})
        acc = (None if self.acc_grads is None else
               [gather_full(a, n, self.mesh).cpu() for a, n in zip(self.acc_grads, names)])
        return dict(step=self.step, params=full(self.student.state_dict()),
                    ema=full(self.teacher.state_dict()), optimizer=opt,
                    thresholder=tuple(t.cpu() for t in self.thresholder), acc_grads=acc)

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """From :meth:`state_dict` (whole leaves); under a mesh each rank
        keeps its pieces."""
        self.step = int(d["step"])
        mesh = self.mesh
        named = dict(self.student.named_parameters())
        names = list(named)

        def pieces(sd, live):
            if mesh is None:
                return sd
            return {k: shard_like(v, k, mesh, live[k]) for k, v in sd.items()}

        self.student.load_state_dict(pieces(d["params"], self.student.state_dict()))
        self.teacher.load_state_dict(pieces(d["ema"], self.teacher.state_dict()))
        opt = d["optimizer"]
        if mesh is not None:   # from the student's order in one group to the optimizer's
            order, saved = self._optimizer_names(), opt["state"]
            pos = {n: i for i, n in enumerate(names)}
            groups, start = [], 0
            for g in self.optimizer.param_groups:
                n = len(g["params"])
                groups.append(dict(opt["param_groups"][0], params=list(range(start, start + n))))
                start += n
            opt = dict(opt, param_groups=groups, state={
                i: {k: (shard_like(v, name, mesh, named[name]) if k != "step" else v)
                    for k, v in saved[pos[name]].items()}
                for i, name in enumerate(order) if pos[name] in saved})
        load_optimizer_state(self.optimizer, opt)
        for t, v in zip(self.thresholder, d["thresholder"]):  # the same tensors
            t.copy_(v)
        if d["acc_grads"] is not None:
            for a, b, n in zip(self.acc_grads, d["acc_grads"], names):
                local(a).copy_(local(shard_like(b, n, mesh, a)) if mesh is not None else b)

    def _optimizer_names(self) -> List[str]:
        """The student's parameter names in the optimizer's order."""
        name = {id(p): n for n, p in self.student.named_parameters()}
        return [name[id(p)] for g in self.optimizer.param_groups for p in g["params"]]


class StepGenerators(NamedTuple):
    seg: Any                # CPU generator: the merge threshold (or the drawn
                            # threshold itself, a 0-d float32 tensor on the device)
    mask: torch.Generator   # device: span-mask draws
    noise: torch.Generator  # device: noise-mixing draws
    drop: Any               # CPU generator: the dropout seeds of the student's layers
                            # (or the reseeded DropoutStreams of StepRandom)


def step_seeds(seed: int, step: int, rank: int = 0) -> List[int]:
    """The four seeds of step ``step`` of a run seeded ``seed``: the merge
    threshold's, the span mask's, the noise mixer's and the dropout's; the
    last is seeded from ``(seed, step, rank)`` on dp ``rank`` > 0."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(4, np.uint64)
    if rank:
        s[3] = np.random.SeedSequence([int(seed), int(step), int(rank)]).generate_state(
            1, np.uint64)[0]
    return [int(v) & (2 ** 63 - 1) for v in s]


def step_generators(seed: int, step: int, device, rank: int = 0) -> StepGenerators:
    """Four independent generators for step ``step`` of a run seeded
    ``seed``; the dropout generator of dp ``rank`` > 0 is seeded from
    ``(seed, step, rank)`` (the others are the same on every rank)."""
    s = step_seeds(seed, step, rank)
    dev = torch.device(device)
    return StepGenerators(torch.Generator().manual_seed(s[0]),
                          torch.Generator(device=dev).manual_seed(s[1]),
                          torch.Generator(device=dev).manual_seed(s[2]),
                          torch.Generator().manual_seed(s[3]))


class StepRandom:
    """The training step's generators, made once per training state and
    reseeded before each step from :func:`step_seeds`: the span mask's and
    the noise mixer's device generators, and one ``DropoutStream`` a dropout
    site of the student (the rest of the model, then each encoder layer).
    They draw what :func:`step_generators`' would draw, bit for bit; being
    the same objects every step, they can be registered with a CUDA graph of
    the step, which then reads the seeds each reseeding sets."""

    def __init__(self, cfg: DistillConfig, device, rank: int = 0):
        dev = torch.device(device)
        self.rank = rank
        self.mask = torch.Generator(device=dev)
        self.noise = torch.Generator(device=dev)
        copies = 2 if cfg.model.remat else 1  # a remat layer draws its masks twice
        self.drop = [DropoutStream(dev, copies) for _ in range(cfg.model.num_hidden_layers + 1)]

    def reseed(self, seed: int, step: int) -> None:
        """Reseed every generator for step ``step``."""
        s = step_seeds(seed, step, self.rank)
        self.mask.manual_seed(s[1])
        self.noise.manual_seed(s[2])
        drop = torch.Generator().manual_seed(s[3])
        for site, v in zip(self.drop, torch.randint(0, 2 ** 62, (len(self.drop),),
                                                    generator=drop).tolist()):
            site.reseed(v)

    def generators(self) -> List[torch.Generator]:
        """Every device generator (for ``CUDAGraph.register_generator_state``)."""
        return [self.mask, self.noise] + [g for site in self.drop for g in site.generators]

    def step_generators(self, merge_threshold: torch.Tensor) -> StepGenerators:
        return StepGenerators(merge_threshold, self.mask, self.noise, self.drop)


def make_optimizer(cfg: DistillConfig, params, capturable: bool = False) -> torch.optim.AdamW:
    """AdamW at lr 0; the step sets the schedule's rate before each update.
    The leaves FSDP shards (DTensors) and the others form two groups: a
    foreach kernel takes no mix of the two. ``capturable`` (CUDA): both keep
    their step counts on the device and compute the bias corrections there
    (torch's capturable AdamW, so that every run on the card rounds alike),
    and the group of plain tensors takes its rate from a 0-d float32 device
    tensor, so that a CUDA graph of the step replays it."""
    params = list(params)
    groups = [[p for p in params if is_dtensor(p)], [p for p in params if not is_dtensor(p)]]
    spec = [{"params": groups[0]}, {"params": groups[1]}]
    if capturable and groups[1]:  # the sharded leaves run eagerly: a rate as a number
        spec[1]["lr"] = torch.zeros((), dtype=torch.float32, device=groups[1][0].device)
    return torch.optim.AdamW([g for g in spec if g["params"]], lr=0.0, betas=(0.9, 0.95),
                             eps=1e-4, weight_decay=cfg.weight_decay, capturable=capturable)


def set_learning_rate(optimizer: torch.optim.Optimizer, value: float,
                      on_device: Optional[torch.Tensor] = None) -> None:
    """Every group's rate to ``value``. A group whose rate is a device tensor
    keeps that tensor and takes ``on_device`` (the same rate as a 0-d device
    tensor: a graph of the step reads it anew) into it, or ``value``."""
    for group in optimizer.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(value)
        elif on_device is not None:
            group["lr"].copy_(on_device)
        else:
            group["lr"].fill_(value)


def host_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` in the layout of a non-capturable AdamW on
    the host (rates as numbers, step counts as CPU tensors), whatever the
    optimizer's groups: a checkpoint resumes on the CPU or the card alike."""
    sd = optimizer.state_dict()
    groups = [dict(g, lr=float(g["lr"]), capturable=False) for g in sd["param_groups"]]
    state = {i: {k: (v.detach().cpu() if k == "step" else v) for k, v in st.items()}
             for i, st in sd["state"].items()}
    return dict(sd, param_groups=groups, state=state)


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: Dict[str, Any]) -> None:
    """Load :func:`host_optimizer_state`'s layout, keeping each group's own
    ``capturable`` flag and device rate tensor (and its step counts on the
    parameters' device). A setting a saved group lacks (a JAX trainer's
    state holds none, ``io/checkpoint.py::train_state_from_jax``) is the
    live group's."""
    kept = [(g["capturable"], g["lr"]) for g in optimizer.param_groups]
    live = optimizer.state_dict()["param_groups"]
    optimizer.load_state_dict(dict(sd, param_groups=[
        {**{k: v for k, v in lg.items() if k != "params"}, **g}
        for lg, g in zip(live, sd["param_groups"], strict=True)]))
    for group, (capturable, lr) in zip(optimizer.param_groups, kept):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        group["capturable"] = capturable
        if capturable:
            for p in group["params"]:
                st = optimizer.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)


def init_train_state(cfg: DistillConfig, device, params: Optional[Dict[str, torch.Tensor]] = None,
                     thresholder_kwargs: Optional[dict] = None, seed: int = 0,
                     mesh: Optional[Mesh] = None, fsdp: bool = False,
                     fsdp_min_size: int = FSDP_MIN_SIZE) -> TrainState:
    """Student from ``params`` (a HubertModel state dict; layers past the
    config's are ignored, a missing weight raises) or seeded random weights;
    the teacher a copy of it: a float32 shadow where ``ema_decay < 1`` and
    ``ema_fp32_shadow``, else in the student's dtypes (JAX's rule; the port
    keeps float32 parameters, as flax does, so the copy is float32 either
    way unless the student's leaves are not). On CUDA the optimizer is
    capturable (:func:`make_optimizer`).
    Under ``mesh`` both are split over its mp axis and, with ``fsdp``, the
    leaves of JAX's FSDP plan (``fsdp_min_size``) sharded over its dp axis
    (``shard_params``); the AdamW moments and accumulators follow the
    parameters."""
    student = HubertModel(cfg.model)
    if params is None:
        init_weights(student, torch.Generator().manual_seed(seed))
    else:
        missing = student.load_state_dict(params, strict=False).missing_keys
        if missing:
            raise KeyError(f"initial parameters lack {missing}")
    student.to(device)
    teacher = HubertModel(cfg.model).to(device).eval().requires_grad_(False)
    shadow = cfg.ema_fp32_shadow and cfg.ema_decay < 1.0
    # assign: the teacher's leaves are ema_init's, in their dtypes
    teacher.load_state_dict(ema_init(student.state_dict(), fp32_shadow=shadow), assign=True)
    if mesh is not None:
        for m in (student, teacher):
            shard_params(m, mesh, fsdp=fsdp, fsdp_min_size=fsdp_min_size)
    acc = None
    if cfg.accumulate_grad_batches > 1:
        acc = [torch.zeros_like(p) for p in student.parameters()]
    capturable = torch.device(device).type == "cuda"
    return TrainState(step=0, student=student, teacher=teacher,
                      optimizer=make_optimizer(cfg, student.parameters(), capturable),
                      thresholder=thresholder_init(**(thresholder_kwargs or {}), device=device),
                      acc_grads=acc, mesh=mesh,
                      rng=StepRandom(cfg, device, rank=mesh.dp_rank if mesh else 0))


# ---- span mask: draws, then a pure function of them ------------------------

def span_mask_draws(generator: torch.Generator, batch: int, max_segs: int,
                    cfg: DistillConfig, device) -> Dict[str, torch.Tensor]:
    """The three (B, MS) draws of ``_span_mask``: Bernoulli uniforms, anchor
    uniforms and span lengths in [1, max_mask_set]."""
    u = lambda: torch.rand(batch, max_segs, generator=generator, device=device)  # noqa: E731
    bern, anchor = u(), u()
    span = torch.randint(1, cfg.max_mask_set + 1, (batch, max_segs), generator=generator,
                         device=device)
    return {"bern": bern, "anchor": anchor, "span": span}


def span_mask_apply(draws: Dict[str, torch.Tensor], segments: torch.Tensor,
                    num_segments: torch.Tensor, num_frames: int,
                    cfg: DistillConfig) -> torch.Tensor:
    """Segment-span masking of the student's input, (B, T) bool
    (``sylber_tpu/train/distill.py::_span_mask``): per item with ``n_b``
    segments, ``max(min_mask_n, Binomial(n_b, mask_prob))`` spans anchored
    uniformly over ``[0, n_b)`` with replacement, each covering 1 to
    ``max_mask_set`` consecutive segments and the frames between them."""
    B, MS, _ = segments.shape
    dev = segments.device
    seg_valid = torch.arange(MS, device=dev)[None, :] < num_segments[:, None]
    bern = (draws["bern"] < cfg.mask_prob) & seg_valid
    mask_n = torch.clamp(bern.sum(-1).clamp_min(cfg.min_mask_n), max=MS)
    anchors = torch.floor(draws["anchor"] * num_segments.clamp_min(1)[:, None].float()).long()
    lastseg = torch.minimum(num_segments[:, None].long(), anchors + draws["span"]) - 1
    bidx = torch.arange(B, device=dev)[:, None]
    start = segments[bidx, anchors, 0].long()
    end = segments[bidx, lastseg.clamp_min(0), 1].long()
    active = (torch.arange(MS, device=dev)[None, :] < mask_n[:, None]) & (num_segments[:, None] > 0)
    starts = torch.where(active, start, num_frames)
    ends = torch.where(active, end, num_frames)
    # union of the active spans by difference counts: +1 at a start, -1 at an end
    delta = torch.zeros(B, num_frames + 1, dtype=torch.int32, device=dev)
    one = torch.ones_like(starts, dtype=torch.int32)
    delta.scatter_add_(1, starts.clamp_max(num_frames), one)
    delta.scatter_add_(1, ends.clamp_max(num_frames), -one)
    return torch.cumsum(delta[:, :num_frames], dim=1) > 0


def _dp_group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.group("dp")


def _span_mask(generator, segments, num_segments, num_frames, cfg: DistillConfig,
               mesh: Optional[Mesh] = None):
    B, MS, _ = segments.shape
    if cfg.mask_prob <= 0.0 and cfg.min_mask_n <= 0:
        return torch.zeros(B, num_frames, dtype=torch.bool, device=segments.device)
    dp = 1 if mesh is None else mesh.dp
    draws = shard_batch(span_mask_draws(generator, B * dp, MS, cfg, segments.device), mesh)
    return span_mask_apply(draws, segments, num_segments, num_frames, cfg)


def _mix_noise(generator, wav, noise, cfg: DistillConfig, mesh: Optional[Mesh]):
    """The noise mixer's draws for the global batch, this rank's rows of
    them, utterance mixing from the global batch."""
    if mesh is None:
        return mix_noise(generator, wav, noise, cfg.noise_mixer)
    draws = shard_batch(noise_draws(generator, wav.shape[0] * mesh.dp, wav.device), mesh)
    source = all_gather_cat(wav, 0, mesh.group("dp"))
    return mix_noise_apply(wav, noise, draws, cfg.noise_mixer, source=source)


def merge_threshold_draw(generator: torch.Generator, cfg: DistillConfig) -> float:
    """``uniform(lo, hi)`` on the host (``lo`` when the range is empty)."""
    lo, hi = cfg.merge_threshold_range
    if not lo < hi:
        return float(lo)
    return float(torch.rand((), generator=generator) * (hi - lo) + lo)


def merge_threshold(seg, cfg: DistillConfig):
    """The step's merge threshold: ``seg`` itself where it is the drawn value
    (a tensor), else drawn on the host from the generator ``seg``."""
    return seg if isinstance(seg, torch.Tensor) else merge_threshold_draw(seg, cfg)


def teacher_targets(teacher: HubertModel, batch: Dict[str, Optional[torch.Tensor]]):
    """The step's inputs and the teacher's frame states: ``(wav, attention_mask,
    target)``, the wav normalised on the device when it is int16 PCM, the
    mask int32, ``target`` (B, T, d) fp32 from the teacher in eval mode
    without autograd (so through the kernels)."""
    wav = batch["input_values"]
    attention_mask = batch.get("attention_mask")
    if attention_mask is not None and attention_mask.dtype != torch.int32:
        attention_mask = attention_mask.to(torch.int32)
    if wav.dtype == torch.int16:
        wav = pcm_normalize(wav, attention_mask)
    teacher.eval()
    with torch.no_grad():
        return wav, attention_mask, teacher(wav, attention_mask).float()


@torch.no_grad()
def online_segments(target: torch.Tensor, attention_mask: Optional[torch.Tensor],
                    thresholder: ThresholderState, gens: StepGenerators, cfg: DistillConfig,
                    mesh: Optional[Mesh] = None):
    """Stage 2's segmentation of the teacher's states: ``(segments,
    num_segments, thresholder, norm_mask)``, the thresholder updated from
    the frame norms (signal only with ``use_train_thrupdate``) of the
    global batch."""
    norm_threshold = get_threshold(thresholder)
    norms = torch.sqrt((target ** 2).sum(-1) + 1e-8)
    norm_mask = norms >= norm_threshold
    flat, fmask = norms.reshape(-1), norm_mask.reshape(-1)
    if cfg.use_train_thrupdate:
        new_thr = update_stats(thresholder, signal=flat, signal_mask=fmask,
                               decay=cfg.thresholder_decay, group=_dp_group(mesh))
    else:
        new_thr = update_stats(thresholder, signal=flat, signal_mask=fmask, noise=flat,
                               noise_mask=~fmask, decay=cfg.thresholder_decay,
                               group=_dp_group(mesh))
    frame_valid = None
    if attention_mask is not None:
        frame_valid = feature_vector_attention_mask(cfg.model, attention_mask,
                                                    target.shape[1]).bool()
    res = segment_batch(target, norm_threshold, merge_threshold(gens.seg, cfg),
                        frame_valid=frame_valid, norms=norms)
    return res.segments, res.num_segments, new_thr, norm_mask


def student_loss(student: HubertModel, wav: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                 target: torch.Tensor, segments: torch.Tensor, num_segments: torch.Tensor,
                 thresholder: ThresholderState, norm_mask: Optional[torch.Tensor],
                 gens: StepGenerators, cfg: DistillConfig, train: bool = True,
                 mesh: Optional[Mesh] = None):
    """Span mask, noise mixing, the student's forward and the loss against
    the segment-averaged teacher fill; returns ``(loss, aux)`` (this rank's
    rows: the loss their mean, the counts their sums)."""
    T = target.shape[1]
    with torch.no_grad():
        mask_time_indices = _span_mask(gens.mask, segments, num_segments, T, cfg, mesh)
        student_in = wav
        if cfg.do_noise_augment and noise is not None:
            if noise.dtype == torch.int16:
                noise = pcm_normalize(noise, attention_mask)
            student_in = _mix_noise(gens.noise, wav, noise, cfg, mesh)

    student.train(train)
    with torch.enable_grad() if train else torch.no_grad():
        hidden = student(student_in, attention_mask, mask_time_indices,
                         generator=gens.drop).float()

    with torch.no_grad():
        if cfg.segment_online and cfg.use_train_thrupdate and norm_mask is not None:
            train_norms = torch.sqrt((hidden.detach() ** 2).sum(-1) + 1e-8)
            thresholder = update_stats(thresholder, noise=train_norms.reshape(-1),
                                       noise_mask=(~norm_mask).reshape(-1),
                                       decay=cfg.thresholder_decay, group=_dp_group(mesh))
        target_fill = averaged_target_fill(target, segments, num_segments)
    loss = ((hidden - target_fill) ** 2).sum(-1).mean()

    aux = {"distillation_loss": loss.detach(), "thresholder": thresholder,
           "num_segments": num_segments.sum(), "masked_frames": mask_time_indices.sum()}
    if cfg.segment_online:
        aux["normthreshold"] = get_threshold(thresholder)
    return cfg.loss_scale * loss, aux


def distill_loss(student: HubertModel, teacher: HubertModel, thresholder: ThresholderState,
                 batch: Dict[str, Optional[torch.Tensor]], gens: StepGenerators,
                 cfg: DistillConfig, train: bool = True, mesh: Optional[Mesh] = None):
    """The distillation loss and its aux dict (``distillation_loss``, the new
    ``thresholder``, ``num_segments``, ``masked_frames``, ``normthreshold``
    in stage 2), all on the device.

    ``batch``: input_values (B, L) float32 normalised or int16 PCM;
    attention_mask (B, L) or None; noise (B, L) or None; segments (B, MS, 2)
    and num_segments (B,) for stage 1, None for online segmentation. Under
    ``mesh`` the batch is this rank's rows of the global batch."""
    wav, attention_mask, target = teacher_targets(teacher, batch)
    norm_mask = None
    if batch.get("segments") is not None:
        segments, num_segments = batch["segments"], batch["num_segments"]
    elif cfg.segment_online:
        segments, num_segments, thresholder, norm_mask = online_segments(
            target, attention_mask, thresholder, gens, cfg, mesh)
    else:
        raise ValueError("the batch has no segments and segment_online is off")
    return student_loss(student, wav, attention_mask, batch.get("noise"), target, segments,
                        num_segments, thresholder, norm_mask, gens, cfg, train, mesh)


def global_norm(tensors: List[torch.Tensor], mesh: Optional[Mesh] = None,
                names: Optional[List[str]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor: under
    a mesh, of the whole tensors (the squares of the TP-split leaves, by
    ``names``, summed over ``mp``; those of FSDP's shards over ``dp``)."""
    pieces = [local(t) for t in tensors]
    # FSDP shards over a dp group of one are whole tensors
    shard = [mesh is not None and mesh.dp > 1 and is_dtensor(t) for t in tensors]
    if mesh is None or (mesh.mp == 1 and not any(shard)):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(pieces)))
    split = [tp_dim(n) is not None for n in names]

    def sum_sq(tp, dp):  # no tensor built from the host: the step stays asynchronous
        ts = [t for t, s, d in zip(pieces, split, shard) if s == tp and d == dp]
        if not ts:
            return torch.zeros((), device=pieces[0].device)
        return torch.stack(torch._foreach_norm(ts)).float().square().sum()

    # the TP pieces summed over mp, then the FSDP shards over dp
    split_sq = torch.stack([sum_sq(True, True), sum_sq(True, False)])
    if mesh.mp > 1:
        dist.all_reduce(split_sq, group=mesh.group("mp"))
    sharded_sq = split_sq[0] + sum_sq(False, True)
    if any(shard):
        dist.all_reduce(sharded_sq, group=mesh.group("dp"))
    return torch.sqrt(sharded_sq + split_sq[1] + sum_sq(False, False))


@torch.no_grad()
def apply_gradients(params: List[torch.Tensor], grads: List[torch.Tensor],
                    optimizer: torch.optim.Optimizer, acc_grads: Optional[List[torch.Tensor]],
                    step: int, cfg: DistillConfig, schedule, norm=global_norm) -> None:
    """``optax.MultiSteps(chain(clip_by_global_norm, adamw))`` on ``grads``
    (one per parameter) at micro-batch ``step``: accumulate the running
    mean in ``acc_grads``, and at the k-th micro-batch clip it and take one
    AdamW step at the schedule's rate for the update count (``schedule``
    None: at the rate the caller set). ``norm``: the global norm of a list
    of gradients (a mesh's, :func:`global_norm`)."""
    k = cfg.accumulate_grad_batches
    if k > 1:
        n = step % k
        acc = [local(a) for a in acc_grads]
        torch._foreach_add_(acc, torch._foreach_div(
            torch._foreach_sub([local(g) for g in grads], acc), n + 1))
        if n < k - 1:
            return
        grads = [a.clone() for a in acc_grads]
        torch._foreach_zero_(acc)
    factor = torch.clamp(cfg.grad_clip / norm(grads), max=1.0)
    torch._foreach_mul_([local(g) for g in grads], factor)
    for p, g in zip(params, grads):
        p.grad = g
    if schedule is not None:
        set_learning_rate(optimizer, schedule(step // k))
    optimizer.step()


def _reduce_metrics(loss, aux, mesh: Optional[Mesh]):
    """The global batch's ``loss`` (the mean of the ranks' means) and
    counts (sums over dp), in one all-reduce."""
    counts = [k for k in ("num_segments", "masked_frames") if k in aux]
    out = reduce_mean({"loss": loss, **{k: aux[k] for k in counts}}, mesh, sums=counts)
    return out.pop("loss"), dict(aux, **out)


def make_train_step(cfg: DistillConfig, mesh: Optional[Mesh] = None):
    """Returns ``(state, batch, seed) -> metrics``: one step, in place on
    ``state``; the metrics are device tensors. Under ``mesh`` (the state's,
    from ``init_train_state(..., mesh=)``) ``batch`` is this rank's rows and
    the metrics are the global batch's."""
    if cfg.model.int8_encoder:
        # its rounding has no gradient and no straight-through estimator:
        # training over it would barely move the projections (as JAX asserts)
        raise ValueError("int8_encoder is an inference/serving mode (no straight-through "
                         "estimator); train in bf16")
    schedule = cosine_warmup_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps,
                                      cfg.min_factor, cfg.hold_steps)

    def values(seed: int, step: int) -> List[float]:
        """Step ``step``'s device row on the host: ``[merge threshold,
        learning rate]``."""
        seg = torch.Generator().manual_seed(step_seeds(seed, step)[0])
        return [merge_threshold_draw(seg, cfg), schedule(step // cfg.accumulate_grad_batches)]

    def reseed(state: TrainState, seed: int, step: int) -> None:
        """The state's step generators (made at the first step) reseeded for
        step ``step``."""
        if state.rng is None:
            device = local(next(state.student.parameters())).device
            state.rng = StepRandom(cfg, device, rank=mesh.dp_rank if mesh else 0)
        state.rng.reseed(seed, step)

    def run(state: TrainState, batch: Dict, row: torch.Tensor, lr: float) -> Dict[str, Any]:
        """One step on device inputs: ``row`` (2,) float32 on the device, the
        merge threshold and the learning rate (``lr`` the same rate as a
        number, taken by a group whose rate is not a device tensor). Reads
        nothing from the device; branches on ``state.step`` only."""
        if cfg.ema_decay < 1.0 and state.step % cfg.accumulate_grad_batches == 0:
            ema_update(state.ema, state.student.state_dict(), cfg.ema_decay)
        named = list(state.student.named_parameters())
        names, params = [n for n, _ in named], [p for _, p in named]
        for p in params:
            p.grad = None
        gens = state.rng.step_generators(row[0])
        norm = (lambda g: global_norm(g, mesh, names)) if mesh is not None else global_norm  # noqa: E731
        # the TF32 flags hold for the backward pass too (cuDNN's default is on)
        with matmul_precision(cfg.model.precision):
            loss, aux = distill_loss(state.student, state.teacher, state.thresholder, batch,
                                     gens, cfg, mesh=mesh)
            loss.backward()
            # a parameter the loss does not reach (masked_spec_embed without
            # masking) has a zero gradient in JAX, and AdamW still decays it
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            # FSDP reduce-scatters its shards' gradients in the backward
            whole = [g for p, g in zip(params, grads) if not is_dtensor(p)]
            if mesh is not None and whole:
                all_reduce_mean_(whole, mesh.group("dp"), mesh.dp)
            grad_norm = norm(grads)
            set_learning_rate(state.optimizer, lr, row[1])
            apply_gradients(params, grads, state.optimizer, state.acc_grads, state.step, cfg,
                            None, norm)
        for t, v in zip(state.thresholder, aux.pop("thresholder")):  # in place
            t.copy_(v)
        state.step += 1
        loss, aux = _reduce_metrics(loss, aux, mesh)
        return {"loss": loss.detach(), "grad_norm": grad_norm, **aux}

    def train_step(state: TrainState, batch: Dict, seed: int) -> Dict[str, Any]:
        reseed(state, seed, state.step)
        vals = values(seed, state.step)
        device = local(next(state.student.parameters())).device
        # from pinned memory without a wait: the caching host allocator keeps
        # the block until the copy has run
        row = _pinned(np.asarray(vals, np.float32), device).to(device, non_blocking=True)
        return run(state, batch, row, vals[1])

    train_step.values, train_step.reseed, train_step.run = values, reseed, run
    return train_step


def make_eval_step(cfg: DistillConfig, mesh: Optional[Mesh] = None):
    """Returns ``(state, batch, seed) -> metrics``: the loss with the student
    in eval mode; the state is not changed. Under ``mesh`` the metrics are
    the global batch's."""
    def eval_step(state: TrainState, batch: Dict, seed: int) -> Dict[str, Any]:
        device = local(next(state.student.parameters())).device
        loss, aux = distill_loss(state.student, state.teacher, state.thresholder, batch,
                                 step_generators(seed, 0, device), cfg, train=False, mesh=mesh)
        aux.pop("thresholder")
        loss, aux = _reduce_metrics(loss, aux, mesh)
        return {"loss": loss, **aux}

    return eval_step
