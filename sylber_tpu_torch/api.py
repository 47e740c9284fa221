"""Public inference API of the PyTorch port: ``Segmenter``.

Port of ``sylber_tpu/api.py::Segmenter``, with the same output contract:
``segmenter(wav_file=... | wav=..., in_second=True)`` returns a dict (or a
list of dicts) with ``segments``, ``segment_features``, ``frame_norms`` and
``hidden_states``.

Inputs are bucketed exactly as in the JAX package (lengths rounded up to
``length_bucket_s``, batches padded to the next batch bucket). The bucket is
not only a matter of speed: the GroupNorm of frontend layer 0 takes its
moments over the padded length, so another padding gives other hidden
states. Padded frames are masked out of segmentation, so batched results
equal single-utterance results.

The segmenter runs on ``cuda`` unless ``device="cpu"`` is passed; without a
GPU and without ``device="cpu"`` it raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .io.checkpoint import load_params_npz, state_dict_from_jax_params
from .models.hubert import (HubertConfig, HubertModel, as_dtype,
                            feature_vector_attention_mask, init_weights,
                            matmul_precision)
from .ops.segment import segment_batch
from .utils.audio import load_for_inference

FRAME_RATE = 50.0  # 320x conv stride at 16 kHz


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``cuda`` by default; raise rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sylber_tpu_torch runs on a CUDA device and none "
                               "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Segmenter:
    """Syllable segmenter: wav -> {segments, segment_features, hidden_states}.

    ``model_ckpt``: a PyTorch ``sylber.ckpt``-style state dict file, a
    ``.npz`` parameter file of the JAX package, or ``None`` for seeded random
    weights (tests and benchmarks). ``params`` takes a JAX parameter tree of
    numpy arrays directly. ``mesh`` and ``speculative_tokens_per_s`` are not
    ported yet and raise.
    """

    def __init__(
        self,
        model_ckpt: Optional[str] = None,
        encoding_layer: int = 9,
        merge_threshold: float = 0.8,
        norm_threshold: float = 2.6,
        dtype: Any = torch.float32,
        precision: str = "highest",
        length_bucket_s: float = 1.0,
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
        params: Optional[Dict[str, Any]] = None,
        hubert_config: Optional[HubertConfig] = None,
        mesh: Optional[Any] = None,
        speculative_tokens_per_s: Optional[float] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError("mesh data parallelism is not ported yet")
        if speculative_tokens_per_s is not None:
            raise NotImplementedError("speculative_tokens_per_s is not ported yet")
        self.device = resolve_device(device)
        self.config = hubert_config or HubertConfig(
            num_hidden_layers=encoding_layer, dtype=as_dtype(dtype),
            precision=precision)
        self.norm_threshold = float(norm_threshold)
        self.merge_threshold = float(merge_threshold)
        self.length_bucket = int(length_bucket_s * 16000)
        self.batch_buckets = tuple(sorted(batch_buckets))

        model = HubertModel(self.config)
        if params is None and model_ckpt is None:
            init_weights(model, torch.Generator().manual_seed(0))
        else:
            sd = (state_dict_from_jax_params(params) if params is not None
                  else self._load_state_dict(model_ckpt, self.config.num_hidden_layers))
            # layers past num_hidden_layers are ignored, as the reference's
            # strict=False load does; a missing weight is an error
            missing = model.load_state_dict(sd, strict=False).missing_keys
            if missing:
                raise KeyError(f"checkpoint lacks {missing}")
        self.model = model.to(self.device).eval()

    @staticmethod
    def _load_state_dict(model_ckpt: str, num_layers: int) -> Dict[str, torch.Tensor]:
        path = Path(model_ckpt)
        if path.is_dir():
            raise NotImplementedError(
                f"{model_ckpt}: Orbax checkpoint directories need JAX; save the "
                "parameters with sylber_tpu.io.checkpoint.save_params_npz and "
                "pass the .npz file")
        if not path.exists():
            raise FileNotFoundError(f"checkpoint {model_ckpt!r} not found")
        if path.suffix == ".npz":
            return state_dict_from_jax_params(load_params_npz(str(path)))
        from .io.torch_convert import load_torch_checkpoint

        return load_torch_checkpoint(str(path), num_hidden_layers=num_layers)

    @torch.inference_mode()
    def _forward_segment(self, wavs: torch.Tensor, attention_mask: torch.Tensor,
                         norm_threshold: float, merge_threshold: float):
        """Encoder forward + segmentation + pooling on one padded batch.

        ``wavs`` may be int16 PCM: it is then normalised on the device to
        zero mean and unit variance over the attended samples."""
        if wavs.dtype == torch.int16:
            x = wavs.float()
            m = attention_mask.float()
            n = m.sum(-1, keepdim=True).clamp_min(1.0)
            mean = (x * m).sum(-1, keepdim=True) / n
            var = (((x - mean) * m) ** 2).sum(-1, keepdim=True) / n
            wavs = (x - mean) / torch.sqrt(var + 1e-7) * m
        hidden = self.model(wavs, attention_mask).float()
        frame_valid = feature_vector_attention_mask(
            self.config, attention_mask, hidden.shape[1]).bool()
        with matmul_precision("highest"):
            res = segment_batch(hidden, norm_threshold, merge_threshold,
                                frame_valid=frame_valid)
        return hidden, res

    # ---- public API ----------------------------------------------------

    def __call__(
        self,
        wav_file: Union[None, str, Path, List] = None,
        wav: Union[None, np.ndarray, List[np.ndarray]] = None,
        in_second: bool = True,
        norm_threshold: Optional[float] = None,
        merge_threshold: Optional[float] = None,
    ):
        if wav_file is not None:
            is_batch = isinstance(wav_file, (list, tuple))
            files = list(wav_file) if is_batch else [wav_file]
            wavs = [load_for_inference(f) for f in files]
        else:
            if wav is None:
                raise ValueError("pass wav_file or wav")
            is_batch = isinstance(wav, (list, tuple))
            wavs = [np.asarray(w, np.float32).reshape(-1)
                    for w in (wav if is_batch else [wav])]
        outputs = self.process(wavs, in_second=in_second,
                               norm_threshold=norm_threshold,
                               merge_threshold=merge_threshold)
        return outputs if is_batch else outputs[0]

    def process(
        self,
        wavs: List[np.ndarray],
        in_second: bool = True,
        norm_threshold: Optional[float] = None,
        merge_threshold: Optional[float] = None,
        return_hidden=True,
    ) -> List[Dict[str, np.ndarray]]:
        """``return_hidden``: True copies the frame features to the host;
        False skips them; "device" leaves them on the device as
        ``hidden_states_device`` with ``num_frames``. Outputs always include
        ``frame_norms``."""
        return self.process_async(wavs, in_second=in_second,
                                  norm_threshold=norm_threshold,
                                  merge_threshold=merge_threshold,
                                  return_hidden=return_hidden)()

    def process_async(
        self,
        wavs: List[np.ndarray],
        in_second: bool = True,
        norm_threshold: Optional[float] = None,
        merge_threshold: Optional[float] = None,
        return_hidden=True,
    ):
        """Upload and run the batch; return a zero-argument ``finalize()``
        producing exactly what :meth:`process` returns.

        Segmentation pass 2 reads its loop bound on the host, so the forward
        has finished when this returns; ``finalize`` does the copies to the
        host. Oversize inputs split into biggest-bucket sub-batches that run
        at finalize time, at most two in flight."""
        nt = self.norm_threshold if norm_threshold is None else float(norm_threshold)
        mt = self.merge_threshold if merge_threshold is None else float(merge_threshold)

        n = len(wavs)
        lengths = [len(w) for w in wavs]
        max_len = _round_up(max(max(lengths), 400), self.length_bucket)
        bsz = next((b for b in self.batch_buckets if b >= n), None)
        if bsz is None:
            big = self.batch_buckets[-1]

            def finalize_all() -> List[Dict[str, np.ndarray]]:
                outs: List[Dict[str, np.ndarray]] = []
                prev = None
                for i in range(0, n, big):
                    cur = self.process_async(wavs[i:i + big], in_second,
                                             nt, mt, return_hidden)
                    if prev is not None:
                        outs.extend(prev())
                    prev = cur
                outs.extend(prev())
                return outs

            return finalize_all

        batch = np.zeros((bsz, max_len), np.float32)
        mask = np.zeros((bsz, max_len), np.int32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
            mask[i, : len(w)] = 1
        hidden, res = self._forward_segment(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(mask).to(self.device), nt, mt)

        def finalize() -> List[Dict[str, np.ndarray]]:
            nseg = res.num_segments.cpu().numpy()
            max_k = max(int(nseg.max()), 1)
            feats = res.features[:, :max_k].cpu().numpy()
            segs = res.segments[:, :max_k].cpu().numpy()
            norms = res.norms.cpu().numpy()
            hidden_host = hidden.cpu().numpy() if return_hidden is True else None

            outputs = []
            for i in range(n):
                k = int(nseg[i])
                seg_i = segs[i, :k].astype(np.int64)
                t_valid = self.config.feat_extract_output_length(lengths[i])
                out = {
                    "segments": seg_i / FRAME_RATE if in_second else seg_i,
                    "segment_features": feats[i, :k].copy() if k else np.array([]),
                    "frame_norms": norms[i, :t_valid],
                }
                if return_hidden is True:
                    out["hidden_states"] = hidden_host[i, :t_valid]
                elif return_hidden == "device":
                    out["hidden_states_device"] = hidden[i]
                    out["num_frames"] = t_valid
                outputs.append(out)
            return outputs

        return finalize
