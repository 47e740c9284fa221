"""HuBERT's encoder in plain PyTorch, float32 with TF32 off.

Follows the published model (Hugging Face ``HubertModel`` with
``feat_extract_norm="group"`` and ``do_stable_layer_norm=False``), as the
configuration file states it:

- frontend: 7 strided convs without bias; layer 0 is followed by a
  GroupNorm with one group a channel (moments over the whole row it is
  given, padding included) and GELU, the others by GELU;
- feature projection: LayerNorm, Linear;
- padded frames zeroed, then the grouped positional conv (the trailing
  frame of the even kernel dropped) and GELU, added;
- the encoder's LayerNorm, then post-LN layers: self-attention whose keys
  past the row's frame count are masked, residual, LayerNorm, feed-forward
  with GELU, residual, LayerNorm.

The GELU of each site is the configuration's: ``gelu`` maps ``layer0``,
``convs``, ``pos_conv`` and ``ffn`` to ``"erf"`` or ``"tanh"``.

The leaves are read by the names of the state dict the benchmark made
(``feature_extractor.convs.<i>.weight``, ``layers.<i>.attention.q_proj.weight``,
...).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN convs for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def num_frames(cfg: Mapping[str, Any], num_samples: int) -> int:
    length = num_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        length = (length - k) // s + 1
    return length


def _gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def no_cast(t: torch.Tensor) -> torch.Tensor:
    return t


def forward(p: Dict[str, torch.Tensor], cfg: Mapping[str, Any], wav: torch.Tensor,
            valid_samples, gelu: Optional[Mapping[str, str]] = None,
            cast: Callable[[torch.Tensor], torch.Tensor] = no_cast,
            dropout: Optional[Callable[[int, torch.Tensor, float], torch.Tensor]] = None,
            dtype: str = "float32") -> torch.Tensor:
    """Last hidden states (B, T, hidden) of ``wav`` (B, L) float32, each row
    holding ``valid_samples[b]`` samples and zeros after them.

    ``gelu``: the GELU of each site (default ``cfg["gelu"]``). ``cast``:
    applied to both operands of every conv and product (a lower precision
    emulated, for the check's control). ``dropout(site, x, rate)``: train
    mode's dropout at site 0 (outside the layers) and ``1 + i`` (layer
    ``i``), called in the model's order: after the encoder's LayerNorm; in a
    layer on the attention probabilities, after the attention block, on
    the feed-forward's activation, after the feed-forward.

    ``dtype="bfloat16"`` computes in the precision a bf16 configuration
    states (flax's ``Dense(dtype=bfloat16)`` over float32 parameters): every
    conv and product takes its operands (the bias too) rounded to bf16 and
    sums in float32; its output, every activation, each residual sum, each
    LayerNorm's output (statistics in float32) and the attention
    probabilities are rounded to bf16; layer 0's conv and GroupNorm run in
    float32 with the output rounded, and the feature projection's LayerNorm
    output stays float32. Every value is held in float32 between roundings."""
    eps, gelu = cfg["layer_norm_eps"], gelu or cfg["gelu"]
    drop = dropout or (lambda site, x, rate: x)
    if dtype == "bfloat16":
        rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        op = lambda t: rnd(cast(t))  # noqa: E731
    else:
        rnd, op = no_cast, cast
    conv = lambda x, w, b=None, **kw: rnd(F.conv1d(op(x), op(w), b if b is None else op(b), **kw))  # noqa: E731
    with exact_fp32():
        x = wav.float()[:, None]
        for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
            if i == 0:
                x = F.conv1d(cast(x), cast(p["feature_extractor.convs.0.weight"]), stride=s)
                x = F.group_norm(x, x.shape[1], p["feature_extractor.group_norm.weight"],
                                 p["feature_extractor.group_norm.bias"], eps)
                x = rnd(_gelu(x, gelu["layer0"]))
            else:
                x = conv(x, p[f"feature_extractor.convs.{i}.weight"], stride=s)
                x = rnd(_gelu(x, gelu["convs"]))
        x = x.transpose(1, 2)
        B, T, _ = x.shape
        lin = lambda t, n: rnd(F.linear(op(t), op(p[n + ".weight"]), op(p[n + ".bias"])))  # noqa: E731
        x = _ln(x, p["feature_projection.layer_norm.weight"],
                p["feature_projection.layer_norm.bias"], eps)
        x = drop(0, lin(x, "feature_projection.projection"), cfg.get("feat_proj_dropout", 0.0))
        frames = torch.tensor([num_frames(cfg, int(n)) for n in valid_samples],
                              device=x.device)
        valid = torch.arange(T, device=x.device)[None, :] < frames[:, None]
        x = x * valid[..., None]
        k = cfg["num_conv_pos_embeddings"]
        pos = conv(x.transpose(1, 2), p["pos_conv_embed.conv.weight"],
                   p["pos_conv_embed.conv.bias"], padding=k // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            pos = pos[:, :, :-1]
        x = rnd(x + rnd(_gelu(pos, gelu["pos_conv"])).transpose(1, 2))
        x = rnd(_ln(x, p["encoder_layer_norm.weight"], p["encoder_layer_norm.bias"], eps))
        x = drop(0, x, cfg.get("hidden_dropout", 0.0))
        H = cfg["num_attention_heads"]
        Dh = cfg["hidden_size"] // H
        mask = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
        heads = lambda t: t.view(B, T, H, Dh).transpose(1, 2)  # noqa: E731
        for i in range(cfg["num_hidden_layers"]):
            q = f"layers.{i}."
            qh = heads(lin(x, q + "attention.q_proj"))
            kh = heads(lin(x, q + "attention.k_proj"))
            vh = heads(lin(x, q + "attention.v_proj"))
            scores = op(qh) @ op(kh).transpose(-1, -2) / math.sqrt(Dh) + mask
            probs = drop(1 + i, rnd(torch.softmax(scores, -1)), cfg.get("attention_dropout", 0.0))
            attn = rnd(op(probs) @ op(vh)).transpose(1, 2).reshape(B, T, -1)
            attn = drop(1 + i, lin(attn, q + "attention.out_proj"), cfg.get("hidden_dropout", 0.0))
            x = rnd(_ln(rnd(x + attn), p[q + "layer_norm.weight"], p[q + "layer_norm.bias"], eps))
            h = rnd(_gelu(lin(x, q + "intermediate_dense"), gelu["ffn"]))
            h = drop(1 + i, h, cfg.get("activation_dropout", 0.0))
            h = drop(1 + i, lin(h, q + "output_dense"), cfg.get("hidden_dropout", 0.0))
            x = rnd(_ln(rnd(x + h), p[q + "final_layer_norm.weight"],
                        p[q + "final_layer_norm.bias"], eps))
    return x
