"""Reference PyTorch checkpoints -> the port's state dicts.

Mirrors ``sylber_tpu/io/torch_convert.py``. Layouts need no change, both
sides being torch: only names are mapped, and weight norms folded into
plain kernels (w = g * v / ||v||; old ``weight_g``/``weight_v`` and new
``parametrizations.weight.original{0,1}`` names).

- HF ``HubertModel`` / ``sylber.ckpt`` -> :class:`~sylber_tpu_torch.models.hubert.HubertModel`
  (the positional conv's norm over every dim but 2; keys the encoder does
  not use dropped, as the reference loads with strict=False);
- the reference ``SegmentSynthesis`` checkpoint -> ``Regressor`` and
  ``InputMLP`` (:func:`load_synthesis_checkpoint`);
- the reference trainable ``Quantizer`` -> a ``QuantizerState``;
- a jik876-style HiFi-GAN generator -> the vocoder's ``Generator``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch


def torch_load(path: str):
    """``torch.load`` restricted to tensors and containers (no pickled code)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def _fold_weight_norm(sd: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """The effective (out, in/groups, k) weight of a weight-normed conv."""
    for g_key, v_key in ((f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1"),
                         (f"{prefix}.weight_g", f"{prefix}.weight_v")):
        if g_key in sd:
            g, v = sd[g_key], sd[v_key]
            norm = v.double().pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
            return (g * v / norm).to(v.dtype)
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    raise KeyError(f"positional conv weight not found under {prefix}")


def state_dict_from_hf(sd: Mapping[str, torch.Tensor],
                       num_hidden_layers: int = 9) -> Dict[str, torch.Tensor]:
    """Map an HF ``HubertModel`` state dict onto the port's module names."""
    out: Dict[str, torch.Tensor] = {}

    def take(src: str, dst: str) -> None:
        out[dst] = sd[src]

    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        take(f"feature_extractor.conv_layers.{i}.conv.weight",
             f"feature_extractor.convs.{i}.weight")
        i += 1
    if i == 0:
        raise KeyError("no conv frontend weights found")
    for p in ("weight", "bias"):
        take(f"feature_extractor.conv_layers.0.layer_norm.{p}",
             f"feature_extractor.group_norm.{p}")
        take(f"feature_projection.layer_norm.{p}", f"feature_projection.layer_norm.{p}")
        take(f"feature_projection.projection.{p}", f"feature_projection.projection.{p}")
        take(f"encoder.layer_norm.{p}", f"encoder_layer_norm.{p}")
    take("masked_spec_embed", "masked_spec_embed")
    out["pos_conv_embed.conv.weight"] = _fold_weight_norm(sd, "encoder.pos_conv_embed.conv")
    take("encoder.pos_conv_embed.conv.bias", "pos_conv_embed.conv.bias")

    for li in range(num_hidden_layers):
        src, dst = f"encoder.layers.{li}", f"layers.{li}"
        for p in ("weight", "bias"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                take(f"{src}.attention.{proj}.{p}", f"{dst}.attention.{proj}.{p}")
            for name in ("layer_norm", "final_layer_norm"):
                take(f"{src}.{name}.{p}", f"{dst}.{name}.{p}")
            for name in ("intermediate_dense", "output_dense"):
                take(f"{src}.feed_forward.{name}.{p}", f"{dst}.{name}.{p}")
    return {k: v.float() for k, v in out.items()}


def load_torch_checkpoint(path: str, num_hidden_layers: int = 9) -> Dict[str, torch.Tensor]:
    """Load a bare HF state dict or a Lightning checkpoint whose keys carry a
    ``net.speech_model.`` (or ``speech_model.``, ``model.``) prefix."""
    obj = torch_load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    for prefix in ("net.speech_model.", "speech_model.", "model."):
        if any(k.startswith(prefix) for k in obj):
            obj = {k[len(prefix):]: v for k, v in obj.items() if k.startswith(prefix)}
            break
    return state_dict_from_hf(obj, num_hidden_layers=num_hidden_layers)


# ---------------- SegmentSynthesis (flow-matching) checkpoints ----------------

def _t(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().float().clone()


def regressor_params_from_torch(sd: Mapping[str, Any], depth: int = 8,
                                prefix: str = "regressor.") -> Dict[str, torch.Tensor]:
    """The reference ``Regressor`` state dict (``flowmatching.py:474-560``)
    -> the port's ``Regressor``. The text-embedding (``to_cond_emb``) and
    ``null_cond`` entries, unused by SegmentSynthesis, are skipped. So is
    each layer's slot 1, the ``gateloop-transformer`` package's
    ``SimpleGateLoopLayer``, as ``sylber_tpu/io/torch_convert.py`` skips it
    (every shipped reference config leaves ``use_gateloop_layers`` off): a
    gateloop regressor's ``gateloop_{i}`` weights come from a JAX-layout
    checkpoint (``io/checkpoint.py::synthesis_state_dict_from_jax``)."""
    g = lambda k: _t(sd[prefix + k])  # noqa: E731
    out = {"proj_in.weight": g("proj_in.weight"), "proj_in.bias": g("proj_in.bias"),
           "time_freqs": g("sinu_pos_emb.0.weights"),
           "time_mlp.weight": g("sinu_pos_emb.1.weight"),
           "time_mlp.bias": g("sinu_pos_emb.1.bias"),
           "to_embed.weight": g("to_embed.weight"), "to_embed.bias": g("to_embed.bias"),
           "conv_pos_embed.weight": g("conv_embed.dw_conv1d.0.weight"),
           "conv_pos_embed.bias": g("conv_embed.dw_conv1d.0.bias"),
           "to_pred.weight": g("to_pred.weight"),
           "transformer.final_norm.gamma": g("transformer.final_norm.gamma")}
    if prefix + "transformer.register_tokens" in sd:
        out["transformer.register_tokens"] = g("transformer.register_tokens")
    for i in range(depth):
        # ModuleList slots: 0 skip_combiner|None, 1 gateloop|None, 2 attention
        # prenorm, 3 attention, 4 feed-forward prenorm, 5 feed-forward
        lp, tp = f"transformer.layers.{i}.", "transformer."
        if prefix + lp + "0.weight" in sd:
            out[f"{tp}skip_combiner_{i}.weight"] = g(lp + "0.weight")
            out[f"{tp}skip_combiner_{i}.bias"] = g(lp + "0.bias")
        for slot, norm in (("2", "attn_norm"), ("4", "ff_norm")):
            for lin in ("to_gamma", "to_beta"):
                for p in ("weight", "bias"):
                    out[f"{tp}{norm}_{i}.{lin}.{p}"] = g(f"{lp}{slot}.{lin}.{p}")
        for lin in ("to_qkv", "to_out"):
            out[f"{tp}attn_{i}.{lin}.weight"] = g(f"{lp}3.{lin}.weight")
        if prefix + lp + "3.q_norm.gamma" in sd:
            out[f"{tp}attn_{i}.q_norm_gamma"] = g(lp + "3.q_norm.gamma")
            out[f"{tp}attn_{i}.k_norm_gamma"] = g(lp + "3.k_norm.gamma")
        for slot, lin in (("0", "proj_in"), ("3", "proj_out")):
            for p in ("weight", "bias"):
                out[f"{tp}ff_{i}.{lin}.{p}"] = g(f"{lp}5.{slot}.{p}")
    return out


def input_mlp_params_from_torch(sd: Mapping[str, Any], n_hidden: int = 2,
                                prefix: str = "input_model.") -> Dict[str, torch.Tensor]:
    """The reference input MLP (``segment_synthesis.py:35-53``: Sequential
    [Linear, RFF] * n_hidden + Linear) -> the port's ``InputMLP``."""
    src = prefix + "mlp."
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_hidden):
        lin, rff = 2 * i, 2 * i + 1
        for p in ("weight", "bias"):
            out[f"in_{i}.{p}"] = _t(sd[f"{src}{lin}.{p}"])
            for part in ("linear1", "linear2", "norm"):
                out[f"rff_{i}.{part}.{p}"] = _t(sd[f"{src}{rff}.{part}.{p}"])
    for p in ("weight", "bias"):
        out[f"out.{p}"] = _t(sd[f"{src}{2 * n_hidden}.{p}"])
    return out


def load_synthesis_checkpoint(path: str, config) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference SegmentSynthesis checkpoint (``synthesis_sylber.ckpt``)
    -> ``{"hubert", "input_mlp", "regressor"}`` state dicts of the port."""
    obj = torch_load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if any(k.startswith("net.") for k in obj):
        obj = {k[len("net."):]: v for k, v in obj.items() if k.startswith("net.")}
    hubert_sd = {k[len("speech_model."):]: v for k, v in obj.items()
                 if k.startswith("speech_model.")}
    return {"hubert": state_dict_from_hf(hubert_sd, num_hidden_layers=config.encoding_layer),
            "input_mlp": input_mlp_params_from_torch(obj, n_hidden=len(config.input_hidden_dims)),
            "regressor": regressor_params_from_torch(obj, depth=config.regressor.depth)}


def quantizer_state_from_torch(sd: Mapping[str, Any], cfg):
    """A reference trainable-Quantizer checkpoint (``quantizer.py:182-257``,
    on vector-quantize-pytorch's GroupedResidualVQ) -> a ``QuantizerState``
    on the CPU (Dense kernels (in, out), as the port's ``FFEncoder`` takes
    them). Codebooks live at ``{art,pitch}_vq.rvqs.{group}.layers.{q}._codebook.embed``
    with a leading dim of 1; the encoder is ``encoder.mlp.{2i}`` Linears
    between FeedForward Sequentials (Linear at .0 and .3)."""
    from ..flow.quantizer import QuantizerState, VQState

    def dense(prefix):
        return {"kernel": _t(sd[f"{prefix}.weight"]).T.contiguous(),
                "bias": _t(sd[f"{prefix}.bias"])}

    n_hidden = len(cfg.hidden_dims)
    encoder = []
    for i in range(n_hidden):
        encoder += [dense(f"encoder.mlp.{2 * i}"), dense(f"encoder.mlp.{2 * i + 1}.0"),
                    dense(f"encoder.mlp.{2 * i + 1}.3")]
    encoder.append(dense(f"encoder.mlp.{2 * n_hidden}"))

    def vq_state(prefix, vq_cfg):
        cbs = torch.zeros(vq_cfg.groups, vq_cfg.num_quantizers, vq_cfg.codebook_size,
                          vq_cfg.dim_group)
        for g in range(vq_cfg.groups):
            for q in range(vq_cfg.num_quantizers):
                e = _t(sd[f"{prefix}.rvqs.{g}.layers.{q}._codebook.embed"])
                cbs[g, q] = e[0] if e.ndim == 3 else e
        return VQState(cbs, torch.ones(cbs.shape[:-1]), cbs.clone())

    return QuantizerState(encoder, vq_state("art_vq", cfg.art_vq),
                          vq_state("pitch_vq", cfg.pitch_vq))


# ---------------- HiFi-GAN vocoder checkpoints ----------------

def _fold_weight_norm_any(sd: Mapping[str, Any], prefix: str) -> torch.Tensor:
    """Fold a weight norm whose kept dim is g's one non-singleton axis, so
    any ``weight_norm(dim=...)`` works."""
    for gk, vk in ((f"{prefix}.parametrizations.weight.original0",
                    f"{prefix}.parametrizations.weight.original1"),
                   (f"{prefix}.weight_g", f"{prefix}.weight_v")):
        if gk in sd:
            g, v = _t(sd[gk]), _t(sd[vk])
            non_single = [i for i, n in enumerate(g.shape) if n > 1]
            dim = non_single[0] if non_single else 0
            axes = tuple(i for i in range(v.ndim) if i != dim)
            norm = v.double().pow(2).sum(dim=axes, keepdim=True).sqrt()
            return (g * v / norm).float()
    return _t(sd[f"{prefix}.weight"])


def hifigan_params_from_torch(sd: Mapping[str, Any], config=None) -> Dict[str, torch.Tensor]:
    """A jik876-style HiFi-GAN ``generator`` state dict (weight norms
    folded) -> the port's ``Generator``: ``conv_pre``, ``ups.{i}``
    (ConvTranspose1d, kept in its (in, out, k) layout), flat
    ``resblocks.{i*K+j}.convs{1,2}.{m}``, ``conv_post``."""
    from ..vocoder.hifigan import HiFiGANConfig

    cfg = config or HiFiGANConfig()
    n_k = len(cfg.resblock_kernel_sizes)
    for cand in ("generator.", "model.generator.", "module."):
        if any(k.startswith(cand) for k in sd):
            sd = {k[len(cand):]: v for k, v in sd.items() if k.startswith(cand)}
            break
    out: Dict[str, torch.Tensor] = {}

    def conv(src, dst):
        out[f"{dst}.weight"] = _fold_weight_norm_any(sd, src)
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    conv("conv_pre", "conv_pre")
    conv("conv_post", "conv_post")
    for i in range(len(cfg.upsample_rates)):
        conv(f"ups.{i}", f"ups_{i}")
        for j in range(n_k):
            rb = f"resblocks.{i * n_k + j}"
            m = 0
            while any(f"{rb}.convs1.{m}.{leaf}" in sd for leaf in (
                    "weight", "weight_v", "parametrizations.weight.original0")):
                conv(f"{rb}.convs1.{m}", f"resblock_{i}_{j}.convs1_{m}")
                conv(f"{rb}.convs2.{m}", f"resblock_{i}_{j}.convs2_{m}")
                m += 1
            if m == 0:
                raise KeyError(f"no convs found under {rb}")
    return out
