"""SegmentSynthesis: syllable features -> articulatory trajectories (SPARC).

Port of the inference half of ``sylber_tpu/synthesis.py``:

    synth = SegmentSynthesis(model_ckpt=..., **sylber_resynthesis.yaml)
    art, segments = synth.resynthesize(input_values=wav, steps=5)
    wav_out = synth.decode_audio(art, spk_emb)

Output: (B, L, 14) trajectories, 12 EMA dims + log-pitch (channel 12,
divided by ``pitch_amp``) + loudness. On the wav path the whole chain runs
on the device with no host read until the end: the HuBERT encoder and the
segmentation kernels (``models/hubert.py``, ``ops/segment.py``), the
averaged fill (or the quantizer's decoded tokens, or the explicit pitch
channel), the input MLP, then the CFM sampler over the voicebox
``Regressor`` (``flow/cfm.py``). ``pitch_amp`` divides channel 12 on the
device; then the segments (with their counts) and ``art`` come to the host
in one copy each.

At inference the regressor gets no attention mask, as in JAX: a padded
batch attends to its padding frames (``kv_len`` = L for every row).
Classifier-free guidance (``cond_scale`` != 1) evaluates the conditioned and
the null field (the conditioning zeroed) as one batch of 2B rows.

The regressor's matmuls and convs run under ``config.regressor.precision``
(``"default"``: TF32 on the card; ``"highest"``: full fp32), the encoder
under its own config's.

Training (``SegmentSynthesis.loss``, :func:`make_synthesis_train_step`):
the frozen encoder's features (precomputed, ``train/synthesis_loop.py``)
through the input MLP (dropout 0.05 in train mode) into the CFM loss over
the regressor, both by autograd; the encoder gets no gradient and no
optimizer slot. The step's draws come from ``train/distill.py``'s
``step_generators`` (or are passed in, as the tests pass JAX's); the
optimizer is the distillation trainer's clip + AdamW
(``apply_gradients``) at clip 0.5, betas (0.9, 0.95), eps 1e-4, weight
decay 0.1 on the warmup-cosine schedule. A step reads nothing from the
device: its metrics are device tensors.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Any, Callable, ClassVar, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .api import resolve_device
from .flow.cfm import CFMDraws, cfm_draws, cfm_loss, sample_adaptive, sample_midpoint
from .io.checkpoint import (jax_params_from_state_dict, load_params_npz,
                            synthesis_state_dict_from_jax, tree_from_state_dict)
from .models.hubert import (HubertConfig, HubertModel, feature_vector_attention_mask,
                            init_weights, matmul_precision)
from .models.voicebox import Regressor, RegressorConfig, init_regressor
from .ops.attention import Dropout
from .ops.segment import averaged_target_fill, segment_batch
from .parallel.mesh import all_reduce_mean_, reduce_mean, shard_batch
from .train.distill import apply_gradients, global_norm, make_optimizer, step_generators
from .train.lr import cosine_warmup_schedule
from .train.thresholder import get_threshold, thresholder_init


class RFF(nn.Module):
    """Residual feed-forward block with post-LayerNorm; dropout after the
    ReLU and after the second linear, from the ``Dropout`` passed in train
    mode."""

    def __init__(self, dim: int, dropout: float = 0.05):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(dim, dim)
        self.linear2 = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)  # flax LayerNorm's epsilon

    def forward(self, x, drop: Dropout = Dropout.OFF):
        h = drop(torch.relu(self.linear1(x)), self.dropout)
        return self.norm(x + drop(self.linear2(h), self.dropout))


class InputMLP(nn.Module):
    """Hidden states -> conditioning embedding; resynthesis width
    768 -> 512 -> 512 -> 256."""

    def __init__(self, input_dim: int, output_dim: int = 256,
                 hidden_dims: Tuple[int, ...] = (512, 512), dropout: float = 0.05):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        dims = (input_dim,) + self.hidden_dims
        for i, dim in enumerate(self.hidden_dims):
            self.add_module(f"in_{i}", nn.Linear(dims[i], dim))
            self.add_module(f"rff_{i}", RFF(dim, dropout))
        self.out = nn.Linear(dims[-1], output_dim)

    def forward(self, x, drop: Dropout = Dropout.OFF):
        """``drop`` applies only in train mode."""
        if not self.training:
            drop = Dropout.OFF
        for i in range(len(self.hidden_dims)):
            x = getattr(self, f"rff_{i}")(getattr(self, f"in_{i}")(x), drop)
        return self.out(x)


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    encoding_layer: int = 9
    hubert: HubertConfig = HubertConfig()
    regressor: RegressorConfig = RegressorConfig()
    input_output_dim: int = 256
    input_hidden_dims: Tuple[int, ...] = (512, 512)
    input_dropout: float = 0.05
    merge_threshold_range: Tuple[float, float] = (0.8, 0.8)
    pitch_amp: float = 5.0
    # append the per-segment mean log(F0 / pitch_cond_mean) measured from the
    # input audio as one more conditioning channel (ops/pitch.py)
    explicit_pitch_cond: bool = False
    pitch_cond_mean: float = 120.0

    @staticmethod
    def from_yaml_dict(cfg: Dict[str, Any]) -> "SynthesisConfig":
        """Reference-style ``sylber_resynthesis.yaml`` keys (and the port's
        ``regressor_configs.precision``, "default" unless given, and
        ``regressor_configs.dtype``, JAX's ``RegressorConfig.dtype``, float32
        unless given: the sampler, the trainers and ``POST /resynthesize``
        run the regressor in it)."""
        r = dict(cfg.get("regressor_configs", {}))
        reg = RegressorConfig(
            dim=r.get("dim", 512), depth=r.get("depth", 8),
            dim_head=r.get("dim_head", 64), heads=r.get("heads", 8),
            dim_in_proj=r.get("dim_in_proj", 64),
            dim_cond_emb=r.get("dim_cond_emb", 256), sigma=r.get("sigma", 0.0),
            use_gateloop_layers=r.get("use_gateloop_layers", False),
            use_unet_skip_connection=r.get("use_unet_skip_connection", False),
            precision=r.get("precision", "default"), dtype=r.get("dtype", "float32"))
        i = dict(cfg.get("input_configs", {}))
        enc = cfg.get("encoding_layer", 9)
        return SynthesisConfig(
            encoding_layer=enc,
            hubert=HubertConfig(num_hidden_layers=enc),
            regressor=reg,
            input_output_dim=i.get("output_dim", 256),
            input_hidden_dims=tuple(i.get("hidden_dims", (512, 512))),
            input_dropout=i.get("dropout", 0.05),
            merge_threshold_range=tuple(cfg.get("merge_threshold_range", (0.8, 0.8))),
            pitch_amp=cfg.get("pitch_amp", 5.0),
            explicit_pitch_cond=cfg.get("explicit_pitch_cond", False),
            pitch_cond_mean=cfg.get("pitch_cond_mean", 120.0))


def synthesis_config_from_dict(cfg: Dict[str, Any]) -> SynthesisConfig:
    """Yaml -> SynthesisConfig, with an optional ``hubert:`` override block
    (the mini recipes); a copy of
    ``sylber_tpu/train/synthesis_loop.py::synthesis_config_from_dict``."""
    sc = SynthesisConfig.from_yaml_dict(cfg)
    hub = cfg.get("hubert")
    if hub:
        extra = {k: tuple(v) if isinstance(v, list) else v for k, v in hub.items()}
        sc = dataclasses.replace(sc, hubert=HubertConfig(
            num_hidden_layers=cfg.get("encoding_layer", 9), **extra))
    return sc


class SegmentSynthesis:
    """Token -> articulation resynthesis, on ``cuda`` unless ``device="cpu"``.

    Weights: ``params``, a JAX tree of numpy arrays with ``hubert``,
    ``input_mlp`` and ``regressor`` subtrees (as the JAX package's
    ``SynthesisParams``); ``model_ckpt``, a ``.npz`` of such a tree, the
    Orbax directory the JAX package's ``SegmentSynthesis.save`` or its
    synthesis trainer writes (read without JAX, by ``io/orbax.py``), or a
    reference torch checkpoint (``io/torch_convert.py``); neither: seeded
    random weights. A path that does not exist raises (no hub download)."""

    def __init__(self, model_ckpt: Optional[str] = None,
                 config: Optional[SynthesisConfig] = None,
                 params: Optional[Mapping[str, Any]] = None,
                 thresholder_configs: Optional[dict] = None,
                 quantizer=None, pitch_quantizer=None, seed: int = 0,
                 device: Union[None, str, torch.device] = None, **yaml_kwargs: Any) -> None:
        self.device = resolve_device(device)
        self.config = config or SynthesisConfig.from_yaml_dict(yaml_kwargs)
        c = self.config
        self.hubert = HubertModel(c.hubert)
        self.input_mlp = InputMLP(c.hubert.hidden_size + int(c.explicit_pitch_cond),
                                  c.input_output_dim, c.input_hidden_dims, c.input_dropout)
        self.regressor = Regressor(c.regressor)
        self.quantizer = quantizer
        self.pitch_quantizer = pitch_quantizer
        self.vocoder = None
        # the thresholder is fixed at inference: its threshold is read once here
        self.default_normthreshold = float(get_threshold(
            thresholder_init(**(thresholder_configs or {}))))

        if params is not None:
            self.load_state_dicts(synthesis_state_dict_from_jax(params))
        elif model_ckpt is not None:
            self.load_state_dicts(self._load(model_ckpt))
        else:
            g = torch.Generator().manual_seed(seed)
            init_weights(self.hubert, g)
            init_regressor(self.regressor, g)
            for m in self.input_mlp.modules():
                if isinstance(m, nn.Linear):
                    m.weight.data.normal_(0.0, m.weight.shape[1] ** -0.5, generator=g)
                    m.bias.data.zero_()
        for m in (self.hubert, self.input_mlp, self.regressor):
            m.to(self.device).eval()

    def load_state_dicts(self, sds: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load ``{"hubert", "input_mlp", "regressor"}`` state dicts of the
        port's modules (encoder layers past ``encoding_layer`` ignored)."""
        missing = self.hubert.load_state_dict(sds["hubert"], strict=False).missing_keys
        if missing:
            raise KeyError(f"encoder checkpoint lacks {missing}")
        # the MLP's input width is the weights' (the encoder's, plus the pitch
        # channel; a VQ tokenizer's output width), as flax infers it
        c = self.config
        self.input_mlp = InputMLP(sds["input_mlp"]["in_0.weight"].shape[1],
                                  c.input_output_dim, c.input_hidden_dims, c.input_dropout)
        self.input_mlp.load_state_dict(sds["input_mlp"])
        self.regressor.load_state_dict(sds["regressor"])
        for m in (self.hubert, self.input_mlp, self.regressor):
            m.to(self.device).eval()

    def _load(self, path: str):
        p = Path(path)
        if p.is_dir():  # the JAX package's SegmentSynthesis.save (Orbax)
            from .io.orbax import load_params

            return synthesis_state_dict_from_jax(load_params(p))
        if not p.exists():
            raise FileNotFoundError(f"checkpoint {path!r} not found")
        if p.suffix == ".npz":
            return synthesis_state_dict_from_jax(load_params_npz(str(p)))
        from .io.torch_convert import load_synthesis_checkpoint

        return load_synthesis_checkpoint(str(p), self.config)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def cond_from_features(self, features: torch.Tensor, quantize: bool = True,
                           pitch_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Norms (no eps), blank threshold 1e-4, optional quantization, the
        input MLP, blank frames zeroed. Explicit-pitch models append the
        frame-filled pitch channel ``pitch_cond`` (B, L) first."""
        norms = torch.sqrt((features ** 2).sum(-1))
        blank = (norms < 1e-4)[..., None]
        if quantize and self.quantizer is not None:
            features = self.quantizer.decode(self.quantizer.get_indices(features))
            features = torch.where(blank, 0.0, features)
        if self.config.explicit_pitch_cond:
            if pitch_cond is None:
                raise ValueError("explicit_pitch_cond model: pass pitch_cond (B, L), see "
                                 "ops/pitch.py::segment_pitch_cond")
            features = torch.cat([features, pitch_cond[..., None].to(features.dtype)], -1)
        with matmul_precision(self.config.regressor.precision):
            cond = self.input_mlp(features)
        return torch.where(blank, 0.0, cond)

    @torch.inference_mode()
    def cond_from_wav(self, wav: torch.Tensor, attention_mask: torch.Tensor,
                      normthreshold: float, merge_threshold: float):
        """Encoder, segmentation, fill and conditioning, enqueued: (cond
        (B, L, dim_cond_emb), the segmentation result)."""
        hidden = self.hubert(wav, attention_mask).float()
        L = hidden.shape[1]
        frame_valid = feature_vector_attention_mask(self.config.hubert, attention_mask,
                                                    L).bool()
        with matmul_precision("highest"):
            res = segment_batch(hidden, normthreshold, merge_threshold, frame_valid=frame_valid)
        if self.quantizer is not None:
            feats = self.quantizer.decode(self.quantizer.get_indices(res.features))
            valid = (torch.arange(res.segments.shape[1], device=wav.device)[None]
                     < res.num_segments[:, None])
            feats = torch.where(valid[..., None], feats, 0.0)
            filled = fill_from_segment_features(feats, res.segments, res.num_segments, L)
        else:
            filled = averaged_target_fill(hidden, res.segments, res.num_segments)
        pitch_fill = None
        if self.config.explicit_pitch_cond:
            from .ops.pitch import segment_pitch_cond

            pitch_fill = segment_pitch_cond(wav, res.segments, res.num_segments, L,
                                            pitch_mean=self.config.pitch_cond_mean,
                                            pitch_quantizer=self.pitch_quantizer)
        return self.cond_from_features(filled, quantize=False, pitch_cond=pitch_fill), res

    def resynthesize(self, input_values=None, attention_mask=None, features=None,
                     steps: int = 5, rand_scale: float = 0.0, merge_threshold: float = 0.8,
                     normthreshold: Optional[float] = None, seed: int = 0,
                     method: str = "midpoint", cond_scale: float = 1.0, pitch_cond=None):
        """(art (B, L, 14) numpy, segments or None): the reference signature.
        ``features`` and ``pitch_cond`` may be arrays or device tensors.

        Explicit-pitch models measure the pitch channel from
        ``input_values`` on the wav path; on the feature path pass
        ``pitch_cond`` (B, L) frame-filled log(F0 / pitch_cond_mean)."""
        def as_t(a):
            if torch.is_tensor(a):
                return a.to(self.device, torch.float32)
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        res = None
        if features is None:
            if input_values is None:
                raise ValueError("pass input_values or features")
            wav = as_t(np.atleast_2d(np.asarray(input_values, np.float32)))
            mask = (torch.as_tensor(np.asarray(attention_mask)).to(self.device)
                    if attention_mask is not None
                    else torch.ones(wav.shape, dtype=torch.int32, device=self.device))
            nt = self.default_normthreshold if normthreshold is None else float(normthreshold)
            cond, res = self.cond_from_wav(wav, mask, nt, merge_threshold)
        else:
            feats = as_t(features)
            if feats.ndim == 2:
                feats = feats[None]
            if pitch_cond is not None:
                pitch_cond = as_t(pitch_cond)
                if pitch_cond.ndim == 1:
                    pitch_cond = pitch_cond[None]
            cond = self.cond_from_features(feats, pitch_cond=pitch_cond)

        art = self.sample(cond, steps, rand_scale, seed, method, cond_scale)
        segments_out = None
        if res is not None:  # counts and segments in one copy
            packed = torch.cat([res.num_segments[:, None].long(),
                                res.segments.long().flatten(1)], 1).cpu().numpy()
            segments_out = [row[1:].reshape(-1, 2)[: int(row[0])].astype(np.int32)
                            for row in packed]
        return art.cpu().numpy(), segments_out

    @torch.inference_mode()
    def sample(self, cond_emb: torch.Tensor, steps: int = 5, rand_scale: float = 0.0,
               seed: int = 0, method: str = "midpoint", cond_scale: float = 1.0,
               return_stats: bool = False):
        """The CFM sampler over the regressor, enqueued: (B, L, 14) on the
        device with channel 12 divided by ``pitch_amp``.

        ``method``: fixed-grid "euler" / "midpoint" / "rk4" over ``steps``
        points, or adaptive "tsit5" / "dopri5" (``steps`` ignored, atol =
        rtol = 1e-5; with ``return_stats`` also the step counts)."""
        reg, dim_out = self.regressor, self.config.regressor.dim_out
        if cond_scale == 1.0:
            def field(x, t):
                return reg(x, t, cond_emb=cond_emb)
        else:
            both_emb = torch.cat([cond_emb, torch.zeros_like(cond_emb)])

            def field(x, t):
                out, null = reg(torch.cat([x, x]), t, cond_emb=both_emb).chunk(2)
                return null + (out - null) * cond_scale

        stats = None
        with matmul_precision(self.config.regressor.precision):
            if method in ("tsit5", "dopri5"):
                art, stats = sample_adaptive(field, cond_emb, dim_out, rand_scale=rand_scale,
                                             method=method, return_stats=True, seed=seed)
            else:
                art = sample_midpoint(field, cond_emb, dim_out, steps, rand_scale,
                                      method=method, seed=seed)
        art = torch.cat([art[..., :12], art[..., 12:13] / self.config.pitch_amp,
                         art[..., 13:]], dim=-1)
        return (art, stats) if return_stats else art

    def decode_audio(self, art, spk_emb, pitch_mean: float = 120.0, vocoder=None) -> np.ndarray:
        """Articulatory trajectory -> 16 kHz waveform through a
        :class:`sylber_tpu_torch.vocoder.SparcDecoder` (``vocoder``, else
        the one attached as ``self.vocoder``, else a random-init one, with a
        warning: it emits noise, not speech)."""
        vocoder = vocoder or self.vocoder
        if vocoder is None:
            from .vocoder import SparcDecoder

            vocoder = self.vocoder = SparcDecoder(device=self.device)
        if getattr(vocoder, "random_init", False):
            warnings.warn(
                "decode_audio: the vocoder has random-init weights and will emit noise, "
                "not speech; pass a trained SparcDecoder (a converted torch HiFi-GAN "
                "checkpoint or a JAX .npz)", stacklevel=2)
        return vocoder(art, spk_emb, pitch_mean)


    # ------------------------------------------------------------ training

    def trainable_modules(self) -> Tuple[nn.Module, nn.Module]:
        return self.input_mlp, self.regressor

    def train_conditioning(self, features: torch.Tensor, pitch_cond: Optional[torch.Tensor] = None,
                           drop: Dropout = Dropout.OFF) -> torch.Tensor:
        """The conditioning of the training path, differentiable: the input
        MLP on ``features`` (with the pitch channel appended for
        explicit-pitch models), frames whose features' norm is below 1e-4
        zeroed (``_cond_from_features_params``)."""
        norms = torch.sqrt((features ** 2).sum(-1))
        if self.config.explicit_pitch_cond:
            if pitch_cond is None:
                raise ValueError("explicit_pitch_cond model: the batch needs a pitch_cond (B, L)")
            features = torch.cat([features, pitch_cond[..., None].to(features.dtype)], -1)
        cond = self.input_mlp(features, drop)
        return torch.where((norms < 1e-4)[..., None], 0.0, cond)

    def loss(self, batch: Mapping[str, torch.Tensor], draws: CFMDraws, train: bool = True,
             cond_fn: Optional[Callable[[Dropout], torch.Tensor]] = None) -> torch.Tensor:
        """The CFM loss of a batch of ``features`` (B, L, d) averaged and
        blanked hidden states, ``art`` (B, L, 14) targets, optional
        ``mask`` (B, L) prefix mask and ``pitch_cond`` (B, L); channel 12 of
        the target is multiplied by ``pitch_amp``. The conditioning is
        ``train_conditioning``'s, or ``cond_fn(dropout)``'s where given (the
        joint-VQ trainer's quantized features). It and the regressor draw
        their dropout masks, in that order, from one ``Dropout`` seeded
        with ``draws.dropout_seed`` (in train mode)."""
        c = self.config
        drop = Dropout(draws.dropout_seed, batch["features"].device) if train else Dropout.OFF
        if cond_fn is None:
            cond = self.train_conditioning(batch["features"], batch.get("pitch_cond"), drop)
        else:
            cond = cond_fn(drop)
        art = batch["art"].float()
        art = torch.cat([art[..., :12], art[..., 12:13] * c.pitch_amp, art[..., 13:]], -1)

        def apply_fn(w, times, x1, cond_emb, mask, cond_mask, _seed, is_train):
            return self.regressor(w, times, cond=x1, cond_emb=cond_emb, self_attn_mask=mask,
                                  cond_mask=cond_mask, dropout=drop if is_train else Dropout.OFF)

        return cfm_loss(apply_fn, draws, art, cond_emb=cond, mask=batch.get("mask"),
                        sigma=c.regressor.sigma, frac_lengths_mask=c.regressor.frac_lengths_mask,
                        train=train)

    def jax_tree(self) -> Dict[str, Any]:
        """``{"hubert", "input_mlp", "regressor"}`` as flax-layout trees of
        numpy arrays (``io/checkpoint.py::save_tree_npz`` writes them as the
        JAX package's ``load_params_npz`` reads them)."""
        return {"hubert": jax_params_from_state_dict(self.hubert.state_dict()),
                "input_mlp": tree_from_state_dict(self.input_mlp.state_dict()),
                "regressor": tree_from_state_dict(self.regressor.state_dict())}


@dataclasses.dataclass(frozen=True)
class SynthesisOptimizer:
    """The reference trainer's recipe: the global-norm clip, then AdamW
    (betas 0.9 / 0.95, eps 1e-4, weight decay 0.1) on the warmup-cosine
    schedule (``make_synthesis_optimizer``). The clip, the decay and the
    single micro-batch are the recipe's constants, read by
    ``train/distill.py``'s ``make_optimizer`` and ``apply_gradients``."""
    lr: float = 1e-4
    warmup_steps: int = 5000
    total_steps: int = 500_000
    min_factor: float = 0.05
    grad_clip: ClassVar[float] = 0.5
    weight_decay: ClassVar[float] = 0.1
    accumulate_grad_batches: ClassVar[int] = 1

    def schedule(self):
        return cosine_warmup_schedule(self.lr, self.warmup_steps, self.total_steps,
                                      self.min_factor)


def make_synthesis_optimizer(lr: float = 1e-4, warmup_steps: int = 5000,
                             total_steps: int = 500_000,
                             min_factor: float = 0.05) -> SynthesisOptimizer:
    return SynthesisOptimizer(lr=lr, warmup_steps=warmup_steps, total_steps=total_steps,
                              min_factor=min_factor)


@dataclasses.dataclass
class SynthesisTrainState:
    step: int                          # updates taken, a host count
    params: list                       # the input MLP's, then the regressor's parameters
    optimizer: torch.optim.AdamW
    synth: Any = None                  # the SegmentSynthesis whose modules hold them


def init_synthesis_train_state(synth: SegmentSynthesis,
                               optimizer: SynthesisOptimizer) -> SynthesisTrainState:
    """AdamW slots for the input MLP and the regressor only: the encoder is
    frozen (no gradient, no slot)."""
    synth.hubert.requires_grad_(False)
    params = [p for m in synth.trainable_modules() for p in m.parameters()]
    for p in params:
        p.requires_grad_(True)
    return SynthesisTrainState(0, params, make_optimizer(optimizer, params), synth)


def train_update(synth: SegmentSynthesis, state, optimizer: SynthesisOptimizer, schedule,
                 loss_fn: Callable[[], Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
                 mesh=None):
    """One update of ``state.params`` in place: the synth's trainable
    modules in train mode, ``loss_fn() -> (loss, aux)`` and its backward
    under the regressor's precision, the gradients averaged over ``mesh``'s
    dp ranks (one flat all-reduce; the state is replicated), then the
    global-norm clip and AdamW (``train/distill.py::apply_gradients``) at
    ``state.step``. Returns ``(loss, aux, grad_norm)``; the caller advances
    ``state.step``."""
    for p in state.params:
        p.grad = None
    for m in synth.trainable_modules():
        m.train()
    try:
        with matmul_precision(synth.config.regressor.precision):
            loss, aux = loss_fn()
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in state.params]
            if mesh is not None:
                all_reduce_mean_(grads, mesh.group("dp"), mesh.dp)
            grad_norm = global_norm(grads)
            apply_gradients(state.params, grads, state.optimizer, None, state.step,
                            optimizer, schedule)
    finally:
        for m in synth.trainable_modules():
            m.eval()
    return loss, aux, grad_norm


def global_cfm_draws(shape, gens, device, mesh=None) -> CFMDraws:
    """The draws for this rank's ``shape[0]`` rows from the step's
    generators ``gens`` (``step_generators(seed, step, device, rank=dp
    rank)``): those of the global batch (``shape[0] * dp`` rows) sliced to
    the rank's, the dropout seed the rank's own."""
    dp = 1 if mesh is None else mesh.dp
    d = cfm_draws((shape[0] * dp,) + tuple(shape[1:]), gens.noise, gens.mask, gens.drop, device)
    if mesh is None:
        return d
    return CFMDraws(*shard_batch([d.x0, d.times, d.frac_u, d.start_u], mesh), d.dropout_seed)


def make_synthesis_train_step(synth: SegmentSynthesis, optimizer: SynthesisOptimizer,
                              loss_scale: float = 1.0, mesh=None):
    """Returns ``(state, batch, seed, draws=None) -> metrics``: one update in
    place, its draws from ``step_generators(seed, state.step)`` unless
    given; ``cfm_loss`` (times ``loss_scale``) and ``grad_norm`` are device
    tensors. Under ``mesh`` (``parallel/mesh.py``) ``batch`` is this rank's
    rows of the global batch, the draws those of the global batch but the
    dropout seed (the rank's own), and the metrics are the global batch's."""
    schedule = optimizer.schedule()

    def train_step(state: SynthesisTrainState, batch: Mapping[str, torch.Tensor], seed: int,
                   draws: Optional[CFMDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            device = state.params[0].device
            g = step_generators(seed, state.step, device, rank=mesh.dp_rank if mesh else 0)
            draws = global_cfm_draws(batch["art"].shape, g, device, mesh)
        loss, _, grad_norm = train_update(
            synth, state, optimizer, schedule,
            lambda: (loss_scale * synth.loss(batch, draws, train=True), {}), mesh)
        state.step += 1
        return {**reduce_mean({"cfm_loss": loss.detach()}, mesh), "grad_norm": grad_norm}

    return train_step


def fill_from_segment_features(seg_feats: torch.Tensor, segments: torch.Tensor,
                               num_segments: torch.Tensor, L: int) -> torch.Tensor:
    """Per-segment vectors (B, MS, d) back at frame level (zeros outside)."""
    B, MS, _ = segments.shape
    t = torch.arange(L, dtype=torch.int32, device=segments.device)
    s, e = segments[..., 0], segments[..., 1]
    valid = torch.arange(MS, device=segments.device)[None, :] < num_segments[:, None]
    covered = ((t[None, None, :] >= s[:, :, None]) & (t[None, None, :] < e[:, :, None])
               & valid[:, :, None])
    seg_id = torch.argmax(covered.to(torch.uint8), dim=1)
    filled = torch.gather(seg_feats, 1, seg_id[..., None].expand(B, L, seg_feats.shape[-1]))
    return torch.where(covered.any(dim=1)[..., None], filled, 0.0)


def expand_feature(avg_fts: torch.Tensor, durations) -> torch.Tensor:
    """Duration-controlled expansion: each segment feature followed by a
    zero "gap" token, repeated by ``durations`` (B, n_segs, 2) (voiced, gap
    lengths; every row must sum to the same length, read from the host
    array). A batched searchsorted over the prefix sums, one gather."""
    B, N, d = avg_fts.shape
    inter = torch.stack([avg_fts, torch.zeros_like(avg_fts)], dim=2).reshape(B, 2 * N, d)
    dur_host = np.asarray(durations.cpu() if torch.is_tensor(durations) else durations)
    L = int(dur_host.reshape(B, -1)[0].sum())
    ends = torch.as_tensor(dur_host.reshape(B, -1)).to(avg_fts.device).cumsum(1)
    t = torch.arange(L, device=avg_fts.device).expand(B, L).contiguous()
    idx = torch.searchsorted(ends.contiguous(), t.to(ends.dtype), right=True)
    return torch.gather(inter, 1, idx[..., None].expand(B, L, d))
