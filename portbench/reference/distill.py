"""Sylber's stage-2 distillation step in plain PyTorch, float32, TF32 off.

One step, as the recipe states it (Sylber's ``sylber_base_stage2.yaml``):

1. the inputs normalised per row (zero mean, unit variance over the
   attended samples, biased variance, eps 1e-7), int16 PCM in;
2. the frozen teacher (``ema_decay`` 1) in eval mode, without dropout;
3. the norm threshold from the thresholder's signal and noise Gaussians
   (the root of the quadratic that equates their likelihoods), the signal
   stats updated from the teacher's frame norms at the voiced frames; the
   teacher's states segmented row by row (``reference/segment.py``) at
   the step's merge threshold; the target each frame's segment mean, 0
   outside every segment;
4. noise mixing of the student's input (an augment gate, another row of
   the batch under a ramp or the noise clip, a magnitude);
5. the student in train mode (dropout), the loss the per-frame squared
   error to the target summed over the width and averaged over frames; the
   noise stats updated from the student's norms at the teacher's unvoiced
   frames;
6. the gradient clipped to a global norm, then AdamW (decoupled decay).

The random draws of a step (the merge threshold, the noise mixer's
uniforms, the dropout masks) are not the reference's own: it draws them
from the program's seeding scheme, ``(seed, step)`` through
``numpy.random.SeedSequence`` into the same torch generators, in the same
order and shapes, so that both sides see the same masks. That scheme is
restated here, not imported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from . import hubert, segment

NOISE_DRAWS = ("aug", "utt", "perm", "shift", "left", "magnitude", "utt_magnitude")


def step_seeds(seed: int, step: int) -> List[int]:
    """The merge threshold's, span mask's, noise mixer's and dropout's seeds."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(4, np.uint64)
    return [int(v) & (2 ** 63 - 1) for v in s]


def pcm_normalize(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x, m = x.float(), mask.float()
    n = m.sum(-1, keepdim=True).clamp_min(1.0)
    mean = (x * m).sum(-1, keepdim=True) / n
    var = (((x - mean) * m) ** 2).sum(-1, keepdim=True) / n
    return (x - mean) / torch.sqrt(var + 1e-7) * m


class Thresholder:
    """Decayed signal and noise Gaussians over frame norms (0-d tensors)."""

    def __init__(self, signal_mean, signal_var, noise_mean, noise_var, device):
        t = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)  # noqa: E731
        self.sm, self.sv, self.nm, self.nv = map(t, (signal_mean, signal_var, noise_mean,
                                                     noise_var))

    def threshold(self) -> torch.Tensor:
        sig_s, sig_n = torch.sqrt(self.sv + 1e-8), torch.sqrt(self.nv + 1e-8)
        a = sig_s ** 2 - sig_n ** 2
        b = -2.0 * sig_s ** 2 * self.nm + 2.0 * sig_n ** 2 * self.sm
        c = (sig_s ** 2 * self.nm ** 2 - sig_n ** 2 * self.sm ** 2
             - 2.0 * sig_n ** 2 * sig_s ** 2 * torch.log(sig_s / sig_n))
        disc = b ** 2 - 4.0 * a * c
        pos = (self.sm > self.nm).float()
        quad = torch.where(disc > 0, (-b + pos * torch.sqrt(disc.clamp_min(0.0))) / (2.0 * a),
                           -b / (2.0 * a))
        return torch.where(a != 0, quad, -c / b)

    @staticmethod
    def _update(mean0, var0, x, mask, decay):
        mask = mask.float()
        cnt = mask.sum()
        mean = torch.where(cnt > 0, (x * mask).sum() / cnt.clamp_min(1.0), torch.zeros_like(cnt))
        new_mean = decay * mean0 + (1 - decay) * mean
        var = torch.where(cnt > 0, ((x - new_mean) ** 2 * mask).sum() / cnt.clamp_min(1.0),
                          torch.zeros_like(cnt))
        new_var = decay * var0 + (1 - decay) * var
        return torch.where(cnt > 0, new_mean, mean0), torch.where(cnt > 0, new_var, var0)

    def update_signal(self, norms, mask, decay):
        self.sm, self.sv = self._update(self.sm, self.sv, norms, mask, decay)

    def update_noise(self, norms, mask, decay):
        self.nm, self.nv = self._update(self.nm, self.nv, norms, mask, decay)


def merge_threshold(cfg: Mapping[str, Any], seed: int, step: int) -> float:
    lo, hi = cfg["merge_threshold_range"]
    g = torch.Generator().manual_seed(step_seeds(seed, step)[0])
    return float(np.float32(float(torch.rand((), generator=g) * (hi - lo) + lo)))


def target_fill(states: torch.Tensor, segs: List[np.ndarray]) -> torch.Tensor:
    """Each frame the mean of its segment's states, 0 outside every segment."""
    out = torch.zeros_like(states)
    for b, rows in enumerate(segs):
        for s, e in rows:
            out[b, s:e] = states[b, s:e].mean(0)
    return out


def mix_noise(cfg: Mapping[str, Any], wav: torch.Tensor, noise: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    c = cfg["noise_mixer_configs"]
    B, L = wav.shape
    u = {k: torch.rand(B, generator=generator, device=wav.device) for k in NOISE_DRAWS}
    perm = torch.argsort(u["perm"])
    is_aug = (u["aug"] <= c["augment_prob"]).float()
    is_utt = (u["utt"] <= c["utterance_mix_ratio"]).float()
    lo, hi = c["shift_range"]
    shift = u["shift"] * (hi - lo) + lo
    ramp = torch.linspace(0.0, 1.0, L, device=wav.device)[None, :]
    left = (ramp > shift[:, None]).float()
    right = (ramp.flip(-1) > shift[:, None]).float()
    is_left = (u["left"] >= 0.5).float()[:, None]
    shuffled = wav[perm]
    src = ((1 - is_utt[:, None]) * noise
           + is_utt[:, None] * (is_left * left * shuffled + (1 - is_left) * right * shuffled))
    mlo, mhi = c["magnitude_range"]
    mag = u["magnitude"] * (mhi - mlo) + mlo
    umag = u["utt_magnitude"] * (c["utterance_magnitude_max_scale"] - mlo) + mlo
    mag = umag * is_utt + (1 - is_utt) * mag
    return wav + is_aug[:, None] * mag[:, None] * src


def dropout_sites(cfg: Mapping[str, Any], seed: int, step: int, device):
    """``dropout(site, x, rate)`` drawing each site's masks from its own
    generator: keep where ``rand < 1 - rate``, scaled by ``1 / (1 - rate)``."""
    g = torch.Generator().manual_seed(step_seeds(seed, step)[3])
    seeds = torch.randint(0, 2 ** 62, (cfg["num_hidden_layers"] + 1,), generator=g).tolist()
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]

    def dropout(site: int, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=gens[site], device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))
    return dropout


def frame_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x ** 2).sum(-1) + 1e-8)


def run_steps(weights: Dict[str, torch.Tensor], cfg: Mapping[str, Any],
              batches: List[Dict[str, torch.Tensor]], seed: int,
              cast: Callable[[torch.Tensor], torch.Tensor] = hubert.no_cast,
              batch_rows: Optional[slice] = None) -> Dict[str, Any]:
    """``len(batches)`` steps from ``weights`` on ``batches`` (dicts of
    ``input_values`` and ``noise`` int16 (B, L), ``attention_mask``), the
    run seeded ``seed``. Returns each step's ``loss`` and ``num_segments``,
    the first step's gradient per leaf as AdamW gets it (``grad1``, after
    the clip) and before the clip (``grad1_raw``), and each leaf's change
    after the last step (``change``), as norms. ``cast``: a lower precision
    for the control. ``batch_rows``: the rows each step keeps (a fault)."""
    device = next(iter(weights.values())).device
    names = list(weights)
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    teacher = {n: w.detach() for n, w in weights.items()}
    opt = torch.optim.AdamW([params[n] for n in names], lr=0.0, betas=tuple(cfg["betas"]),
                            eps=cfg["adam_eps"], weight_decay=cfg["weight_decay"])
    thr = Thresholder(**cfg["thresholder_configs"], device=device)
    decay = cfg["thresholder_decay"]
    lr = float(np.float32(cfg["lr"]))  # warm-up 0 and a floor factor of 1: constant
    out: Dict[str, Any] = {"loss": [], "num_segments": []}
    for step, batch in enumerate(batches):
        if batch_rows is not None:
            batch = {k: v[batch_rows] for k, v in batch.items()}
        mask = batch["attention_mask"].int()
        lengths = mask.sum(-1).tolist()
        wav = pcm_normalize(batch["input_values"], mask)
        with torch.no_grad():
            target = hubert.forward(teacher, cfg, wav, lengths, cast=cast)
            norms = frame_norms(target)
            norm_thr = thr.threshold()
            voiced = norms >= norm_thr
            thr.update_signal(norms.reshape(-1), voiced.reshape(-1), decay)
            mt = merge_threshold(cfg, seed, step)
            states = target.cpu().numpy()
            nthr = float(norm_thr)
            frames = [hubert.num_frames(cfg, n) for n in lengths]
            segs = [segment.segment(states[b, :frames[b]], nthr, mt) for b in range(len(states))]
            fill = target_fill(target, segs)
            seeds = step_seeds(seed, step)
            noise_gen = torch.Generator(device=device).manual_seed(seeds[2])
            student_in = mix_noise(cfg, wav, pcm_normalize(batch["noise"], mask), noise_gen)
        hidden = hubert.forward(params, cfg, student_in, lengths, gelu=cfg["gelu_student"],
                                cast=cast, dropout=dropout_sites(cfg, seed, step, device))
        with torch.no_grad():
            thr.update_noise(frame_norms(hidden).reshape(-1), (~voiced).reshape(-1), decay)
        loss = ((hidden - fill) ** 2).sum(-1).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            grads = [params[n].grad if params[n].grad is not None
                     else torch.zeros_like(params[n]) for n in names]
            total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = torch.clamp(cfg["grad_clip"] / total, max=1.0)
            if step == 0:
                out["grad1_raw"] = {n: float(g.norm()) for n, g in zip(names, grads)}
            torch._foreach_mul_(grads, factor)
            if step == 0:
                out["grad1"] = {n: float(g.norm()) for n, g in zip(names, grads)}
            for n, g in zip(names, grads):
                params[n].grad = g
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        out["loss"].append(float(loss.detach()))
        out["num_segments"].append(int(sum(len(s) for s in segs)))
        del hidden, loss, target, fill
    out["change"] = {n: float((params[n].detach() - weights[n]).norm()) for n in names}
    return out
