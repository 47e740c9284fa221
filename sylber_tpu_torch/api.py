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

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .data.device import pcm_normalize
from .io.checkpoint import load_state_dict, state_dict_from_jax_params
from .models.hubert import (HubertConfig, HubertModel, as_dtype,
                            feature_vector_attention_mask, init_weights,
                            matmul_precision)
from .ops.segment import segment_batch
from .parallel.mesh import Mesh, local_rank
from .utils.audio import load_for_inference

FRAME_RATE = 50.0  # 320x conv stride at 16 kHz


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``cuda`` by default (``cuda:LOCAL_RANK`` in a process group, one rank
    a GPU); raise rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sylber_tpu_torch runs on a CUDA device and none "
                               "is available; pass device='cpu' to run on the CPU")
        if dist.is_initialized():
            return torch.device("cuda", local_rank())
        return torch.device("cuda")
    return torch.device(device)


class Segmenter:
    """Syllable segmenter: wav -> {segments, segment_features, hidden_states}.

    ``model_ckpt``: a PyTorch ``sylber.ckpt``-style state dict file, a
    ``.npz`` parameter file of the JAX package, an Orbax directory of the JAX
    package (its trainer's ``params_final``; read without JAX, by
    ``io/orbax.py``), or ``None`` for seeded random weights (tests and
    benchmarks). ``params`` takes a JAX parameter tree of
    numpy arrays directly.

    ``mesh`` (``parallel/mesh.py::make_mesh(dp, devices=[...])``, a mesh of
    replicas in this process): a copy of the encoder on each of its ``dp``
    devices (a device may hold several); each padded batch is split into
    ``dp`` equal row blocks, every replica's forward and segmentation are
    enqueued before anything waits, and the results are concatenated in
    order on the first device (``self.device``). The batch buckets keep
    only multiples of ``dp`` (``(dp,)`` if none is), as in JAX.

    ``speculative_tokens_per_s`` (serving): right after the forward is
    enqueued, start one copy to pinned host memory of the segment counts,
    the frame norms and the first K segments and segment features, with K
    sized from this assumed largest token rate (tokens per second of the
    padded batch, plus 8). ``finalize`` waits for that copy's event, its
    only wait for those bytes; when the batch's largest segment count fits
    in K it fetches nothing more (but the hidden states, if asked for),
    and when it does not, the segments and features are fetched as without
    the option. The outputs are the same either way.
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
        if mesh is not None and not (isinstance(mesh, Mesh) and mesh.device_mesh is None):
            raise ValueError("the Segmenter takes a data-parallel mesh of replicas in this "
                             "process: parallel.mesh.make_mesh(dp, devices=[...])")
        self.mesh = mesh
        self.speculative_tokens_per_s = (float(speculative_tokens_per_s)
                                         if speculative_tokens_per_s else None)
        self.device = resolve_device(device) if mesh is None else mesh.devices[0]
        self.config = hubert_config or HubertConfig(
            num_hidden_layers=encoding_layer, dtype=as_dtype(dtype),
            precision=precision)
        self.norm_threshold = float(norm_threshold)
        self.merge_threshold = float(merge_threshold)
        self.length_bucket = int(length_bucket_s * 16000)
        self.batch_buckets = tuple(sorted(batch_buckets))
        if mesh is not None:
            self.batch_buckets = tuple(b for b in self.batch_buckets
                                       if b % mesh.dp == 0) or (mesh.dp,)

        model = HubertModel(self.config)
        if params is None and model_ckpt is None:
            init_weights(model, torch.Generator().manual_seed(0))
        else:
            sd = (state_dict_from_jax_params(params) if params is not None
                  else load_state_dict(model_ckpt, self.config.num_hidden_layers))
            # layers past num_hidden_layers are ignored, as the reference's
            # strict=False load does; a missing weight is an error
            missing = model.load_state_dict(sd, strict=False).missing_keys
            if missing:
                raise KeyError(f"checkpoint lacks {missing}")
        self.model = model.to(self.device).eval()
        self.replicas = [self.model]
        if mesh is not None:
            self.replicas += [copy.deepcopy(model).to(d).eval() for d in mesh.devices[1:]]

    @torch.inference_mode()
    def _forward_segment(self, wavs: torch.Tensor, attention_mask: torch.Tensor,
                         norm_threshold: float, merge_threshold: float):
        """Encoder forward + segmentation + pooling on one padded batch (on
        ``self.device``); under a mesh, each replica on its rows.

        ``wavs`` may be int16 PCM: it is then normalised on the device to
        zero mean and unit variance over the attended samples."""
        if self.mesh is None:
            return self._forward_replica(self.model, wavs, attention_mask, norm_threshold,
                                         merge_threshold)
        dp = self.mesh.dp
        outs = [self._forward_replica(m, w.to(d, non_blocking=True),
                                      a.to(d, non_blocking=True), norm_threshold,
                                      merge_threshold)
                for m, d, w, a in zip(self.replicas, self.mesh.devices, wavs.chunk(dp),
                                      attention_mask.chunk(dp))]
        hidden = torch.cat([h.to(self.device, non_blocking=True) for h, _ in outs])
        res = type(outs[0][1])(*(torch.cat([r[i].to(self.device, non_blocking=True)
                                            for _, r in outs])
                                 for i in range(len(outs[0][1]))))
        return hidden, res

    def _forward_replica(self, model: HubertModel, wavs: torch.Tensor,
                         attention_mask: torch.Tensor, norm_threshold: float,
                         merge_threshold: float):
        if wavs.dtype == torch.int16:
            wavs = pcm_normalize(wavs, attention_mask)
        hidden = model(wavs, attention_mask).float()
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
        """Upload the batch and enqueue its forward and segmentation; return a
        zero-argument ``finalize()`` producing exactly what :meth:`process`
        returns.

        Nothing here waits for the device: on a GPU the call returns while
        the forward is still running (time ``finalize()`` with it). The first
        host wait is in ``finalize``, which holds every copy to the host that
        waits; a server overlaps one batch's ``finalize`` with the next
        batch's dispatch. Oversize inputs split into biggest-bucket
        sub-batches that run at finalize time, at most two in flight."""
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
        prefix = None
        if self.speculative_tokens_per_s:
            k = min(int(np.ceil(max_len / 16000.0 * self.speculative_tokens_per_s)) + 8,
                    res.features.shape[1])
            prefix = start_host_copy(res.num_segments[:n], res.norms[:n],
                                     res.segments[:n, :k], res.features[:n, :k])

        def finalize() -> List[Dict[str, np.ndarray]]:
            return self._collect(hidden, res, lengths, in_second, return_hidden, prefix)

        return finalize

    def _collect(self, hidden: torch.Tensor, res, lengths: Sequence[int],
                 in_second: bool, return_hidden, prefix=None) -> List[Dict[str, Any]]:
        """Copy the results of the first ``len(lengths)`` rows of a batch to
        the host and cut them to each row's length (in samples). The segments
        and their features are fetched as the prefix ``[:, :max(num_segments)]``,
        or read from ``prefix``, the copy of the speculative option started by
        :func:`start_host_copy`, when it holds that many."""
        n = len(lengths)
        held = 0
        if prefix is None:
            nseg = res.num_segments[:n].cpu().numpy()
            norms = res.norms[:n].cpu().numpy()
        else:
            (nseg_h, norms_h, segs_h, feats_h), done = prefix
            if done is not None:
                done.synchronize()  # nothing else orders these reads: stale bytes until then
            nseg, norms, held = nseg_h.numpy(), norms_h.numpy().copy(), feats_h.shape[1]
        max_k = max(int(nseg.max()), 1)
        if max_k <= held:
            segs, feats = segs_h[:, :max_k].numpy(), feats_h[:, :max_k].numpy()
        else:
            segs = res.segments[:n, :max_k].cpu().numpy()
            feats = res.features[:n, :max_k].cpu().numpy()
        hidden_host = hidden[:n].cpu().numpy() if return_hidden is True else None

        outputs = []
        for i in range(n):
            k = int(nseg[i])
            seg_i = segs[i, :k].astype(np.int64)
            t_valid = self.config.feat_extract_output_length(int(lengths[i]))
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


def start_host_copy(*tensors: torch.Tensor):
    """Start copying ``tensors`` to the host: ``(host tensors, event)``. From
    CUDA tensors the copies go to pinned memory without waiting; their bytes
    may be read only after ``event.synchronize()``. From CPU tensors they are
    plain copies and the event is ``None``."""
    if tensors[0].device.type != "cuda":
        return tuple(t.clone() for t in tensors), None
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    return tuple(hosts), done
