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

The codebooks' EMA update (``vq_ema_update``) belongs to the trainer and is
not ported yet. Parameters keep the JAX layouts (Dense kernels (in, out)), as
torch tensors on one device. The nearest-code search is the k-means one,
a full-precision fp32 distance matmul.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from ..quantizer import KMQuantizer, ResidualKMQuantizer, _nearest, load_km_quantizer

__all__ = ["KMQuantizer", "ResidualKMQuantizer", "load_km_quantizer", "unit_norm",
           "unit_norm_sep", "GroupedResidualVQConfig", "VQState", "vq_encode", "vq_decode",
           "vq_forward", "FFEncoder", "QuantizerConfig", "QuantizerState", "quantizer_init",
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

    def vq(c: GroupedResidualVQConfig) -> VQState:
        cb = torch.randn(c.groups, c.num_quantizers, c.codebook_size, c.dim_group,
                         generator=generator) * 0.02
        return VQState(cb, torch.ones(cb.shape[:-1]), cb.clone())

    state = QuantizerState(enc, vq(cfg.art_vq), vq(cfg.pitch_vq))
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
