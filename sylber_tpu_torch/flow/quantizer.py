"""The trainable art/pitch quantizer at inference, and the pitch-token quantizer.

Port of the inference half of ``sylber_tpu/flow/quantizer.py`` (the frozen
k-means quantizers are ``sylber_tpu_torch/quantizer.py``):

- the grouped residual VQ (``vq_encode`` / ``vq_decode`` / ``vq_forward``)
  over a :class:`VQState` of codebooks (groups, quantizers, K, d_group);
- :class:`FFEncoder` and :func:`quantizer_forward` / :func:`quantizer_decode`:
  features -> unit norm -> MLP -> unit norm per art/pitch sub-space -> blank
  frames kept zero -> VQ of each sub-space;
- :func:`load_quantizer` from a reference torch checkpoint;
- :class:`ScalarPitchQuantizer`, the uniform pitch-token quantizer of the
  explicit-pitch path.

and the training half: :func:`vq_init` and :func:`vq_ema_update`, the EMA
k-means update of the codebooks with dead-code reseeding. Parameters keep
the JAX layouts (Dense kernels (in, out)), as torch tensors on one device.
The nearest-code search is the k-means one, a full-precision fp32 distance
matmul.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..quantizer import KMQuantizer, ResidualKMQuantizer, _nearest, load_km_quantizer

__all__ = ["KMQuantizer", "ResidualKMQuantizer", "load_km_quantizer", "unit_norm",
           "unit_norm_sep", "GroupedResidualVQConfig", "VQState", "vq_encode", "vq_decode",
           "vq_forward", "vq_init", "vq_ema_update", "vq_reseed_draw", "FFEncoder", "QuantizerConfig", "QuantizerState", "quantizer_init",
           "quantizer_forward", "quantizer_decode", "load_quantizer", "ScalarPitchQuantizer"]


def unit_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps), zeros kept finite."""
    n = torch.sqrt((x ** 2).sum(-1, keepdim=True) + eps)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def unit_norm_sep(x: torch.Tensor, separate: bool, offset: int) -> torch.Tensor:
    if separate:
        return torch.cat([unit_norm(x[..., :-offset]), unit_norm(x[..., -offset:])], -1)
    return unit_norm(x)


class VQState(NamedTuple):
    codebooks: torch.Tensor      # (groups, num_quantizers, K, d_group)
    cluster_sizes: torch.Tensor  # (groups, num_quantizers, K) EMA counts
    embed_avgs: torch.Tensor     # EMA sums of the k-means update


@dataclasses.dataclass(frozen=True)
class GroupedResidualVQConfig:
    dim: int
    groups: int = 1
    num_quantizers: int = 1
    codebook_size: int = 1024
    decay: float = 0.99
    eps: float = 1e-5
    commitment_weight: float = 1.0
    dead_threshold: float = 1.0

    @property
    def dim_group(self) -> int:
        if self.dim % self.groups:
            raise ValueError(f"dim {self.dim} not divisible by {self.groups} groups")
        return self.dim // self.groups


def vq_encode(state: VQState, cfg: GroupedResidualVQConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., dim) -> int32 indices (..., groups * num_quantizers)."""
    all_idx = []
    for g, part in enumerate(torch.split(x, cfg.dim_group, dim=-1)):
        residual = part
        for q in range(cfg.num_quantizers):
            idx = _nearest(residual, state.codebooks[g, q])
            all_idx.append(idx)
            residual = residual - state.codebooks[g, q][idx.long()]
    return torch.stack(all_idx, dim=-1)


def vq_decode(state: VQState, cfg: GroupedResidualVQConfig, indices: torch.Tensor) -> torch.Tensor:
    outs = []
    i = 0
    for g in range(cfg.groups):
        acc = 0.0
        for q in range(cfg.num_quantizers):
            idx = indices[..., i].clamp(0, cfg.codebook_size - 1).long()
            acc = acc + state.codebooks[g, q][idx]
            i += 1
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def vq_forward(state: VQState, cfg: GroupedResidualVQConfig, x: torch.Tensor):
    """(quantized with straight-through gradients, indices, commitment loss)."""
    idx = vq_encode(state, cfg, x.detach())
    q = vq_decode(state, cfg, idx)
    commit = ((q.detach() - x) ** 2).mean() * cfg.commitment_weight
    return x + (q - x).detach(), idx, commit


def vq_init(cfg: GroupedResidualVQConfig, generator: torch.Generator, device=None) -> VQState:
    """Codebooks normal(0, 0.02), EMA counts 1, EMA sums the codebooks."""
    cb = torch.randn(cfg.groups, cfg.num_quantizers, cfg.codebook_size, cfg.dim_group,
                     generator=generator) * 0.02
    return VQState(cb.to(device), torch.ones(cb.shape[:-1], device=device), cb.clone().to(device))


def vq_reseed_draw(generator: torch.Generator, mask: torch.Tensor, shape) -> torch.Tensor:
    """Indices (``shape``) of points drawn uniformly, with replacement, among
    those where ``mask`` (n,) is positive (among all where none is): the
    draw of JAX's ``categorical(where(m > 0, 0, -1e9))``, by the inverse CDF
    of float64 uniforms from ``generator``, with no read from the device."""
    w = torch.where((mask > 0).any(), (mask > 0).double(), torch.ones_like(mask, dtype=torch.float64))
    cum = torch.cumsum(w, 0)
    u = torch.rand(shape, generator=generator, device=mask.device, dtype=torch.float64)
    idx = torch.searchsorted(cum, (u * cum[-1]).reshape(-1), right=True)
    return idx.clamp_max(mask.shape[0] - 1).reshape(shape)


@torch.no_grad()
def vq_ema_update(state: VQState, cfg: GroupedResidualVQConfig, x: torch.Tensor,
                  indices: torch.Tensor, generator: Optional[torch.Generator] = None,
                  mask: Optional[torch.Tensor] = None,
                  sample_idx: Optional[torch.Tensor] = None) -> VQState:
    """EMA k-means update of the codebooks (vector-quantize-pytorch
    semantics, ``sylber_tpu/flow/quantizer.py::vq_ema_update``): per group
    and quantizer, the one-hot counts and sums of the residual (masked by
    ``mask``, broadcast to x's leading dims), decayed into the EMA counts
    and sums, the codes that got points set to sum / max(count, eps), then
    ``residual -= old_codebook[idx]``. With ``generator`` (or injected
    ``sample_idx`` (groups, quantizers, K)), codes whose EMA count fell
    below ``dead_threshold`` are reseeded, when any point is valid, from
    valid batch vectors (:func:`vq_reseed_draw`), with count
    ``2 * dead_threshold``."""
    parts = torch.split(x.reshape(-1, cfg.dim), cfg.dim_group, dim=-1)
    flat_idx = indices.reshape(-1, cfg.groups * cfg.num_quantizers)
    n_pts = flat_idx.shape[0]
    if mask is not None:
        m = torch.broadcast_to(mask, x.shape[:-1]).reshape(n_pts).to(x.dtype)
    else:
        m = torch.ones(n_pts, dtype=x.dtype, device=x.device)
    any_valid = m.sum() > 0
    reseed = generator is not None or sample_idx is not None
    if reseed and sample_idx is None:
        sample_idx = vq_reseed_draw(generator, m,
                                    (cfg.groups, cfg.num_quantizers, cfg.codebook_size))
    new_cb, new_sz, new_avg = [], [], []
    i = 0
    for g, part in enumerate(parts):
        residual = part
        g_cb, g_sz, g_avg = [], [], []
        for q in range(cfg.num_quantizers):
            idx = flat_idx[:, i].long()
            onehot = F.one_hot(idx, cfg.codebook_size).to(part.dtype) * m[:, None]
            counts = onehot.sum(0)
            sums = onehot.T @ residual
            sz = state.cluster_sizes[g, q] * cfg.decay + counts * (1 - cfg.decay)
            avg = state.embed_avgs[g, q] * cfg.decay + sums * (1 - cfg.decay)
            cb = torch.where(counts[:, None] > 0, avg / torch.clamp_min(sz, cfg.eps)[:, None],
                             state.codebooks[g, q])
            if reseed:
                dead = (sz < cfg.dead_threshold) & any_valid
                seeds = residual[sample_idx[g, q].long()]
                grace = 2.0 * cfg.dead_threshold
                cb = torch.where(dead[:, None], seeds, cb)
                sz = torch.where(dead, torch.full_like(sz, grace), sz)
                avg = torch.where(dead[:, None], seeds * grace, avg)
            residual = residual - state.codebooks[g, q][idx]
            g_cb.append(cb)
            g_sz.append(sz)
            g_avg.append(avg)
            i += 1
        new_cb.append(torch.stack(g_cb))
        new_sz.append(torch.stack(g_sz))
        new_avg.append(torch.stack(g_avg))
    return VQState(torch.stack(new_cb), torch.stack(new_sz), torch.stack(new_avg))


class FFEncoder:
    """MLP of ``quantizer.py:15-31``: per hidden width a Linear, then a
    (non-residual) Linear -> ReLU -> Linear; a final Linear. Parameters are
    a list of ``{"kernel": (in, out), "bias": (out,)}``."""

    @staticmethod
    def apply(params: List[dict], x: torch.Tensor, n_hidden: int) -> torch.Tensor:
        i = 0
        for _ in range(n_hidden):
            x = x @ params[i]["kernel"] + params[i]["bias"]
            h = torch.relu(x @ params[i + 1]["kernel"] + params[i + 1]["bias"])
            x = h @ params[i + 2]["kernel"] + params[i + 2]["bias"]
            i += 3
        return x @ params[i]["kernel"] + params[i]["bias"]


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Trainable art/pitch quantizer (``quantizer.py:182-257``)."""
    input_dim: int = 768
    output_dim: int = 64
    hidden_dims: Tuple[int, ...] = (256, 256)
    pitch_emb_dim: int = 8
    art_vq: GroupedResidualVQConfig = GroupedResidualVQConfig(dim=56)
    pitch_vq: GroupedResidualVQConfig = GroupedResidualVQConfig(dim=8)
    unit_norm_encoder_input: bool = True
    unit_norm_encoder_output: bool = True
    keep_blank_zero: bool = True
    separate_norm: bool = True


class QuantizerState(NamedTuple):
    encoder: list
    art_vq: VQState
    pitch_vq: VQState


def quantizer_init(cfg: QuantizerConfig, generator: torch.Generator, device=None) -> QuantizerState:
    """Seeded random state: Glorot-uniform encoder kernels, zero biases,
    codebooks normal(0, 0.02) (the JAX initialiser's distributions)."""
    def dense(din, dout):
        lim = (6.0 / (din + dout)) ** 0.5
        return {"kernel": (torch.rand(din, dout, generator=generator) * 2 - 1) * lim,
                "bias": torch.zeros(dout)}

    enc, dims = [], [cfg.input_dim]
    for h in cfg.hidden_dims:
        enc += [dense(dims[-1], h), dense(h, h), dense(h, h)]
        dims.append(h)
    enc.append(dense(dims[-1], cfg.output_dim))

    state = QuantizerState(enc, vq_init(cfg.art_vq, generator), vq_init(cfg.pitch_vq, generator))
    return quantizer_to(state, device)


def quantizer_to(state: QuantizerState, device) -> QuantizerState:
    """The state's tensors on ``device`` (float32)."""
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device)  # noqa: E731
    return QuantizerState([{k: as_t(v) for k, v in layer.items()} for layer in state.encoder],
                          VQState(*(as_t(a) for a in state.art_vq)),
                          VQState(*(as_t(a) for a in state.pitch_vq)))


def quantizer_forward(state: QuantizerState, cfg: QuantizerConfig, token: torch.Tensor):
    """token (B, L, d) -> dict(indices, quantize, non_quantized,
    commitment_loss), the semantics of ``quantizer.py:213-241``."""
    non_blank = (token ** 2).sum(-1) > 0
    if cfg.unit_norm_encoder_input:
        token = unit_norm(token)
    token = FFEncoder.apply(state.encoder, token, len(cfg.hidden_dims))
    if cfg.unit_norm_encoder_output:
        token = unit_norm_sep(token, cfg.separate_norm, cfg.pitch_emb_dim)
    if cfg.keep_blank_zero:
        token = torch.where(non_blank[..., None], token, 0.0)

    art, pitch = token[..., :-cfg.pitch_emb_dim], token[..., -cfg.pitch_emb_dim:]
    art_q, art_idx, art_loss = vq_forward(state.art_vq, cfg.art_vq, art)
    pitch_q, pitch_idx, pitch_loss = vq_forward(state.pitch_vq, cfg.pitch_vq, pitch)
    quantized = torch.cat([art_q, pitch_q], -1)
    if cfg.unit_norm_encoder_output:
        quantized = unit_norm_sep(quantized, cfg.separate_norm, cfg.pitch_emb_dim)
    return {"indices": torch.cat([art_idx, pitch_idx], -1), "quantize": quantized,
            "non_quantized": token, "commitment_loss": art_loss + pitch_loss}


def quantizer_decode(state: QuantizerState, cfg: QuantizerConfig,
                     indices: torch.Tensor) -> torch.Tensor:
    indices = indices.clamp_min(0)
    n_art = cfg.art_vq.groups * cfg.art_vq.num_quantizers
    q = torch.cat([vq_decode(state.art_vq, cfg.art_vq, indices[..., :n_art]),
                   vq_decode(state.pitch_vq, cfg.pitch_vq, indices[..., n_art:])], -1)
    if cfg.unit_norm_encoder_output:
        q = unit_norm_sep(q, cfg.separate_norm, cfg.pitch_emb_dim)
    return q


def load_quantizer(config=None, ckpt=None, device=None):
    """A trainable quantizer from a yaml path or dict config and/or a
    reference torch checkpoint (``quantizer.py:47-77``): (QuantizerState,
    QuantizerConfig). Without a state dict the state is seeded random."""
    from ..api import resolve_device
    from ..io.torch_convert import quantizer_state_from_torch, torch_load

    device = resolve_device(device)
    state_dict = None
    if config is not None and not isinstance(config, dict):
        if str(config).endswith(".ckpt"):
            return load_quantizer(config=None, ckpt=config, device=device)
        import yaml

        with open(config) as f:
            config = yaml.safe_load(f)
    if config is None:
        if ckpt is None:
            raise ValueError("load_quantizer needs a config or a checkpoint")
        obj = torch_load(ckpt)
        config = obj["config"]
        state_dict = obj.get("state_dict")
    if "model" in config:
        config = config["model"]

    enc = config["encoder_configs"]
    qcfg = QuantizerConfig(
        input_dim=enc["input_dim"], output_dim=enc["output_dim"],
        hidden_dims=tuple(enc["hidden_dims"]),
        pitch_emb_dim=config.get("pitch_emb_dim", 8),
        art_vq=GroupedResidualVQConfig(**config["art_vq_configs"]),
        pitch_vq=GroupedResidualVQConfig(**config["pitch_vq_configs"]),
        unit_norm_encoder_input=config.get("unit_norm_encoder_input", True),
        unit_norm_encoder_output=config.get("unit_norm_encoder_output", True),
        keep_blank_zero=config.get("keep_blank_zero", True),
        separate_norm=config.get("separate_norm", True))
    if state_dict is None and ckpt is not None:
        obj = torch_load(ckpt)
        state_dict = obj.get("state_dict", obj)
    if state_dict is not None:
        return quantizer_to(quantizer_state_from_torch(state_dict, qcfg), device), qcfg
    return quantizer_init(qcfg, torch.Generator().manual_seed(0), device), qcfg


class ScalarPitchQuantizer:
    """Uniform scalar quantizer of the per-segment mean log-pitch: index 0
    is "unvoiced segment", 1..n_bins cover [lo, hi] uniformly."""

    def __init__(self, n_bins: int = 64, lo: float = -0.54, hi: float = 1.21):
        if n_bins < 2 or hi <= lo:
            raise ValueError(f"need n_bins >= 2 and hi > lo, got {n_bins}, {lo}, {hi}")
        self.n_bins = int(n_bins)
        self.lo, self.hi = float(lo), float(hi)
        self.step = (self.hi - self.lo) / self.n_bins

    @property
    def vocab_size(self) -> int:
        return self.n_bins + 1  # + the unvoiced token

    def get_indices(self, values: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
        """(values, has) (B, MS) -> int32 tokens (B, MS); 0 = unvoiced."""
        b = torch.floor((values - self.lo) / self.step).to(torch.int32)
        b = b.clamp(0, self.n_bins - 1)
        return torch.where(has, b + 1, 0).to(torch.int32)

    def decode(self, indices: torch.Tensor):
        """Tokens -> (bin-centre values, has) (B, MS)."""
        has = indices > 0
        centers = self.lo + (indices.float() - 0.5) * self.step
        return torch.where(has, centers, 0.0), has
