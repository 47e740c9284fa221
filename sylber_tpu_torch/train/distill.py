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
   generator and reaches the kernels as a launch argument, where JAX draws
   it on the device: no kernel reads it from memory and nothing is read
   back;
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
``(seed, step)`` (:func:`step_generators`), so a resumed run repeats an
uninterrupted one. The state is updated in place (the JAX step returns a
new one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.device import pcm_normalize
from ..data.noise import NoiseMixerConfig, mix_noise
from ..models.hubert import (HubertConfig, HubertModel, feature_vector_attention_mask,
                             init_weights, matmul_precision)
from ..ops.segment import averaged_target_fill, segment_batch
from .ema import ema_init, ema_update
from .lr import cosine_warmup_schedule
from .thresholder import ThresholderState, get_threshold, thresholder_init, update_stats


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    model: HubertConfig = HubertConfig()
    ema_decay: float = 1.0                     # frozen teacher, as both recipes
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

    @property
    def ema(self) -> Dict[str, torch.Tensor]:
        return self.teacher.state_dict()

    def state_dict(self) -> Dict[str, Any]:
        return dict(step=self.step, params=self.student.state_dict(),
                    ema=self.teacher.state_dict(), optimizer=self.optimizer.state_dict(),
                    thresholder=tuple(self.thresholder), acc_grads=self.acc_grads)

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.step = int(d["step"])
        self.student.load_state_dict(d["params"])
        self.teacher.load_state_dict(d["ema"])
        self.optimizer.load_state_dict(d["optimizer"])
        dev = self.thresholder.signal_mean.device
        self.thresholder = ThresholderState(*(t.to(dev) for t in d["thresholder"]))
        if d["acc_grads"] is not None:
            for a, b in zip(self.acc_grads, d["acc_grads"]):
                a.copy_(b)


class StepGenerators(NamedTuple):
    seg: torch.Generator    # CPU: the merge threshold
    mask: torch.Generator   # device: span-mask draws
    noise: torch.Generator  # device: noise-mixing draws
    drop: torch.Generator   # CPU: the dropout seeds of the student's layers


def step_generators(seed: int, step: int, device) -> StepGenerators:
    """Four independent generators for step ``step`` of a run seeded ``seed``."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(4, np.uint64)
    s = [int(v) & (2 ** 63 - 1) for v in s]
    dev = torch.device(device)
    return StepGenerators(torch.Generator().manual_seed(s[0]),
                          torch.Generator(device=dev).manual_seed(s[1]),
                          torch.Generator(device=dev).manual_seed(s[2]),
                          torch.Generator().manual_seed(s[3]))


def make_optimizer(cfg: DistillConfig, params) -> torch.optim.AdamW:
    """AdamW at lr 0; the step sets the schedule's rate before each update."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.95), eps=1e-4,
                             weight_decay=cfg.weight_decay)


def init_train_state(cfg: DistillConfig, device, params: Optional[Dict[str, torch.Tensor]] = None,
                     thresholder_kwargs: Optional[dict] = None, seed: int = 0) -> TrainState:
    """Student from ``params`` (a HubertModel state dict; layers past the
    config's are ignored, a missing weight raises) or seeded random weights;
    the teacher a copy of it (an fp32 shadow where ``ema_decay < 1``; the
    port keeps float32 parameters, so the copy is float32 either way)."""
    student = HubertModel(cfg.model)
    if params is None:
        init_weights(student, torch.Generator().manual_seed(seed))
    else:
        missing = student.load_state_dict(params, strict=False).missing_keys
        if missing:
            raise KeyError(f"initial parameters lack {missing}")
    student.to(device)
    teacher = HubertModel(cfg.model).to(device).eval().requires_grad_(False)
    teacher.load_state_dict(ema_init(student.state_dict(), fp32_shadow=cfg.ema_decay < 1.0))
    acc = None
    if cfg.accumulate_grad_batches > 1:
        acc = [torch.zeros_like(p) for p in student.parameters()]
    return TrainState(step=0, student=student, teacher=teacher,
                      optimizer=make_optimizer(cfg, student.parameters()),
                      thresholder=thresholder_init(**(thresholder_kwargs or {}), device=device),
                      acc_grads=acc)


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


def _span_mask(generator, segments, num_segments, num_frames, cfg: DistillConfig):
    B, MS, _ = segments.shape
    if cfg.mask_prob <= 0.0 and cfg.min_mask_n <= 0:
        return torch.zeros(B, num_frames, dtype=torch.bool, device=segments.device)
    draws = span_mask_draws(generator, B, MS, cfg, segments.device)
    return span_mask_apply(draws, segments, num_segments, num_frames, cfg)


def merge_threshold_draw(generator: torch.Generator, cfg: DistillConfig) -> float:
    """``uniform(lo, hi)`` on the host (``lo`` when the range is empty)."""
    lo, hi = cfg.merge_threshold_range
    if not lo < hi:
        return float(lo)
    return float(torch.rand((), generator=generator) * (hi - lo) + lo)


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
                    thresholder: ThresholderState, gens: StepGenerators, cfg: DistillConfig):
    """Stage 2's segmentation of the teacher's states: ``(segments,
    num_segments, thresholder, norm_mask)``, the thresholder updated from
    the frame norms (signal only with ``use_train_thrupdate``)."""
    norm_threshold = get_threshold(thresholder)
    norms = torch.sqrt((target ** 2).sum(-1) + 1e-8)
    norm_mask = norms >= norm_threshold
    flat, fmask = norms.reshape(-1), norm_mask.reshape(-1)
    if cfg.use_train_thrupdate:
        new_thr = update_stats(thresholder, signal=flat, signal_mask=fmask,
                               decay=cfg.thresholder_decay)
    else:
        new_thr = update_stats(thresholder, signal=flat, signal_mask=fmask, noise=flat,
                               noise_mask=~fmask, decay=cfg.thresholder_decay)
    frame_valid = None
    if attention_mask is not None:
        frame_valid = feature_vector_attention_mask(cfg.model, attention_mask,
                                                    target.shape[1]).bool()
    res = segment_batch(target, norm_threshold, merge_threshold_draw(gens.seg, cfg),
                        frame_valid=frame_valid, norms=norms)
    return res.segments, res.num_segments, new_thr, norm_mask


def student_loss(student: HubertModel, wav: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                 target: torch.Tensor, segments: torch.Tensor, num_segments: torch.Tensor,
                 thresholder: ThresholderState, norm_mask: Optional[torch.Tensor],
                 gens: StepGenerators, cfg: DistillConfig, train: bool = True):
    """Span mask, noise mixing, the student's forward and the loss against
    the segment-averaged teacher fill; returns ``(loss, aux)``."""
    T = target.shape[1]
    with torch.no_grad():
        mask_time_indices = _span_mask(gens.mask, segments, num_segments, T, cfg)
        student_in = wav
        if cfg.do_noise_augment and noise is not None:
            if noise.dtype == torch.int16:
                noise = pcm_normalize(noise, attention_mask)
            student_in = mix_noise(gens.noise, wav, noise, cfg.noise_mixer)

    student.train(train)
    with torch.enable_grad() if train else torch.no_grad():
        hidden = student(student_in, attention_mask, mask_time_indices,
                         generator=gens.drop).float()

    with torch.no_grad():
        if cfg.segment_online and cfg.use_train_thrupdate and norm_mask is not None:
            train_norms = torch.sqrt((hidden.detach() ** 2).sum(-1) + 1e-8)
            thresholder = update_stats(thresholder, noise=train_norms.reshape(-1),
                                       noise_mask=(~norm_mask).reshape(-1),
                                       decay=cfg.thresholder_decay)
        target_fill = averaged_target_fill(target, segments, num_segments)
    loss = ((hidden - target_fill) ** 2).sum(-1).mean()

    aux = {"distillation_loss": loss.detach(), "thresholder": thresholder,
           "num_segments": num_segments.sum(), "masked_frames": mask_time_indices.sum()}
    if cfg.segment_online:
        aux["normthreshold"] = get_threshold(thresholder)
    return cfg.loss_scale * loss, aux


def distill_loss(student: HubertModel, teacher: HubertModel, thresholder: ThresholderState,
                 batch: Dict[str, Optional[torch.Tensor]], gens: StepGenerators,
                 cfg: DistillConfig, train: bool = True):
    """The distillation loss and its aux dict (``distillation_loss``, the new
    ``thresholder``, ``num_segments``, ``masked_frames``, ``normthreshold``
    in stage 2), all on the device.

    ``batch``: input_values (B, L) float32 normalised or int16 PCM;
    attention_mask (B, L) or None; noise (B, L) or None; segments (B, MS, 2)
    and num_segments (B,) for stage 1, None for online segmentation."""
    wav, attention_mask, target = teacher_targets(teacher, batch)
    norm_mask = None
    if batch.get("segments") is not None:
        segments, num_segments = batch["segments"], batch["num_segments"]
    elif cfg.segment_online:
        segments, num_segments, thresholder, norm_mask = online_segments(
            target, attention_mask, thresholder, gens, cfg)
    else:
        raise ValueError("the batch has no segments and segment_online is off")
    return student_loss(student, wav, attention_mask, batch.get("noise"), target, segments,
                        num_segments, thresholder, norm_mask, gens, cfg, train)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def apply_gradients(params: List[torch.Tensor], grads: List[torch.Tensor],
                    optimizer: torch.optim.Optimizer, acc_grads: Optional[List[torch.Tensor]],
                    step: int, cfg: DistillConfig, schedule) -> None:
    """``optax.MultiSteps(chain(clip_by_global_norm, adamw))`` on ``grads``
    (one per parameter) at micro-batch ``step``: accumulate the running
    mean in ``acc_grads``, and at the k-th micro-batch clip it and take one
    AdamW step at the schedule's rate for the update count."""
    k = cfg.accumulate_grad_batches
    if k > 1:
        n = step % k
        torch._foreach_add_(acc_grads, torch._foreach_div(
            torch._foreach_sub(grads, acc_grads), n + 1))
        if n < k - 1:
            return
        grads = [a.clone() for a in acc_grads]
        torch._foreach_zero_(acc_grads)
    factor = torch.clamp(cfg.grad_clip / global_norm(grads), max=1.0)
    torch._foreach_mul_(grads, factor)
    for p, g in zip(params, grads):
        p.grad = g
    for group in optimizer.param_groups:
        group["lr"] = schedule(step // k)
    optimizer.step()


def make_train_step(cfg: DistillConfig):
    """Returns ``(state, batch, seed) -> metrics``: one step, in place on
    ``state``; the metrics are device tensors."""
    if cfg.model.int8_encoder:
        # its rounding has no gradient and no straight-through estimator:
        # training over it would barely move the projections (as JAX asserts)
        raise ValueError("int8_encoder is an inference/serving mode (no straight-through "
                         "estimator); train in bf16")
    schedule = cosine_warmup_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps,
                                      cfg.min_factor, cfg.hold_steps)

    def train_step(state: TrainState, batch: Dict, seed: int) -> Dict[str, Any]:
        if cfg.ema_decay < 1.0 and state.step % cfg.accumulate_grad_batches == 0:
            ema_update(state.ema, state.student.state_dict(), cfg.ema_decay)
        params = list(state.student.parameters())
        for p in params:
            p.grad = None
        device = params[0].device
        # the TF32 flags hold for the backward pass too (cuDNN's default is on)
        with matmul_precision(cfg.model.precision):
            loss, aux = distill_loss(state.student, state.teacher, state.thresholder, batch,
                                     step_generators(seed, state.step, device), cfg)
            loss.backward()
            # a parameter the loss does not reach (masked_spec_embed without
            # masking) has a zero gradient in JAX, and AdamW still decays it
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            grad_norm = global_norm(grads)
            apply_gradients(params, grads, state.optimizer, state.acc_grads, state.step, cfg,
                            schedule)
        state.thresholder = aux.pop("thresholder")
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, **aux}

    return train_step


def make_eval_step(cfg: DistillConfig):
    """Returns ``(state, batch, seed) -> metrics``: the loss with the student
    in eval mode; the state is not changed."""
    def eval_step(state: TrainState, batch: Dict, seed: int) -> Dict[str, Any]:
        device = next(state.student.parameters()).device
        loss, aux = distill_loss(state.student, state.teacher, state.thresholder, batch,
                                 step_generators(seed, 0, device), cfg, train=False)
        aux.pop("thresholder")
        return {"loss": loss, **aux}

    return eval_step
