"""``Sylber``: the reference's object surface over the functional trainer.

Port of ``sylber_tpu/models/sylber.py``. The training path is the
functional one of ``train/distill.py``; this class wraps it for interactive
use:

    model = Sylber(segment_online=True, thresholder_configs={...})
    model.ema_step()                      # the teacher's update
    out = model(input_values, noise=...)  # {'distillation_loss': ...}
    feats, segments, avg_fts = model.segment(input_values)

It composes only ported parts: ``ops/segment.py::segment_batch``,
``train/distill.py::distill_loss``, ``train/ema.py`` and
``train/thresholder.py::get_threshold``. Differences from JAX: the EMA
updates the teacher's tensors in place (intended difference (q)), the
merge threshold and the step's draws come from torch generators seeded
with ``seed + 1`` (intended difference (n)), and ``forward``'s
``distillation_loss`` keeps its autograd graph, so ``.backward()`` reaches
the student. On ``cuda`` unless ``device="cpu"``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..api import resolve_device
from ..data.noise import NoiseMixerConfig
from ..ops.segment import segment_batch
from ..train.distill import DistillConfig, distill_loss, init_train_state, step_generators
from ..train.ema import ema_update
from ..train.thresholder import get_threshold
from .hubert import HubertConfig, matmul_precision


class Sylber:
    def __init__(self, encoding_layer: int = 9, ema_decay: float = 0.999,
                 do_noise_augment: bool = False, noise_mixer_configs: Optional[dict] = None,
                 mask_prob: float = 0.0, segment_online: bool = False,
                 thresholder_configs: Optional[dict] = None, min_mask_n: int = 0,
                 merge_threshold_range=(0.5, 0.7), max_mask_set: int = 1,
                 use_train_thrupdate: bool = False, hubert_config: Optional[HubertConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                 device: Union[None, str, torch.device] = None, **kwargs: Any) -> None:
        """``params``: a ``HubertModel`` state dict for the student (seeded
        random weights without one)."""
        self.device = resolve_device(device)
        self.config = DistillConfig(
            model=hubert_config or HubertConfig(num_hidden_layers=encoding_layer),
            ema_decay=ema_decay, segment_online=segment_online,
            merge_threshold_range=tuple(merge_threshold_range),
            use_train_thrupdate=use_train_thrupdate, mask_prob=mask_prob,
            min_mask_n=min_mask_n, max_mask_set=max_mask_set,
            do_noise_augment=do_noise_augment,
            noise_mixer=NoiseMixerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in (noise_mixer_configs or {}).items()}))
        state = init_train_state(self.config, self.device, params=params,
                                 thresholder_kwargs=thresholder_configs or {}, seed=seed)
        self.model = state.student
        self.teacher = None
        self.thresholder = state.thresholder
        self._seed = seed + 1
        self._calls = 0
        self._merge_rng = torch.Generator().manual_seed(seed + 1)

    def ema_step(self) -> None:
        """The first call snapshots the student as the teacher; later calls
        decay the teacher toward the student, in place."""
        if self.teacher is None:
            self.teacher = copy.deepcopy(self.model).eval().requires_grad_(False)
        else:
            ema_update(self.teacher.state_dict(), self.model.state_dict(), self.config.ema_decay)

    def _tensor(self, a, dtype=None):
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        return t.to(self.device, dtype)

    def segment(self, input_values, attention_mask=None, mergethreshold=None,
                normthreshold=None, features=None, **kwargs):
        """``(features (B, T, d), segments [(n_b, 2) numpy], segment
        features (B, MS, d))``; the student's frame states in eval mode
        (through the kernels on the card) unless ``features`` are given."""
        if features is None:
            wav = self._tensor(np.atleast_2d(np.asarray(input_values)), torch.float32)
            self.model.eval()
            with torch.no_grad():
                features = self.model(wav, self._tensor(attention_mask, torch.int32)).float()
        else:
            features = self._tensor(features, torch.float32)
        if normthreshold is None:
            if not self.config.segment_online:
                raise ValueError("pass normthreshold: this model has no online thresholder")
            normthreshold = float(get_threshold(self.thresholder))
        if mergethreshold is None:
            lo, hi = self.config.merge_threshold_range
            mergethreshold = float(lo)
            if lo < hi:  # from the façade's own stream, seeded at construction
                mergethreshold = float(torch.rand((), generator=self._merge_rng) * (hi - lo) + lo)
        with matmul_precision("highest"):
            res = segment_batch(features, normthreshold, mergethreshold)
        counts = res.num_segments.cpu().numpy()
        segs = res.segments.cpu().numpy()
        return features, [segs[b][: counts[b]] for b in range(len(counts))], res.features

    def forward(self, input_values, segments=None, attention_mask=None, noise=None,
                **kwargs) -> Dict[str, Any]:
        """The distillation loss of a batch: ``{"distillation_loss" (with
        its graph), "num_segments", "masked_frames", ["normthreshold"]}``;
        the thresholder's stats are updated. ``segments``: per item (n, 2)
        arrays (stage 1), else the teacher's states are segmented online.
        The draws come from generators seeded by the call count."""
        if self.teacher is None:
            self.ema_step()
        batch = {"input_values": self._tensor(np.atleast_2d(np.asarray(input_values))),
                 "attention_mask": self._tensor(attention_mask),
                 "noise": self._tensor(noise), "segments": None}
        if segments is not None:
            MS = max(len(s) for s in segments) + 1
            seg = np.zeros((len(segments), MS, 2), np.int32)
            cnt = np.zeros((len(segments),), np.int32)
            for b, s in enumerate(segments):
                seg[b, : len(s)] = s
                cnt[b] = len(s)
            batch["segments"], batch["num_segments"] = self._tensor(seg), self._tensor(cnt)
        gens = step_generators(self._seed, self._calls, self.device)
        self._calls += 1
        with matmul_precision(self.config.model.precision):
            loss, aux = distill_loss(self.model, self.teacher, self.thresholder, batch, gens,
                                     self.config)
        self.thresholder = aux.pop("thresholder")
        aux.pop("distillation_loss")
        return {"distillation_loss": loss, **aux}

    __call__ = forward
