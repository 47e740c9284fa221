"""Batches on the device: the corpus uploaded once, or each batch copied ahead.

Port of ``sylber_tpu/data/device.py`` (under a mesh each rank gathers the
global batch and keeps its rows: ``parallel/mesh.py::shard_batch``). For a corpus that fits in device
memory (the synthetic one), :func:`precollate` collates every item once
(the host stream would give the same items: they are deterministic and
cached) and uploads it; :func:`device_stream` then gathers each batch on the
device by an index vector, so a step copies ``4 * B`` bytes. Padding is to
the corpus's longest item instead of the batch's (the masks say the same).

For streamed corpora :func:`to_device` copies one collated batch through
pinned memory with non-blocking copies on a side stream and hands back an
event; :func:`wait_ready` makes the current stream wait for it before the
batch is used.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _pinned(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def pcm_normalize(x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-item zero mean / unit variance over the attended samples, zeros in
    the padding: the device side of the int16 transfer (the host collate's
    float32 normalisation, with the biased variance and eps 1e-7)."""
    x = x.float()
    m = torch.ones_like(x) if attention_mask is None else attention_mask.float()
    n = m.sum(-1, keepdim=True).clamp_min(1.0)
    mean = (x * m).sum(-1, keepdim=True) / n
    var = (((x - mean) * m) ** 2).sum(-1, keepdim=True) / n
    return (x - mean) / torch.sqrt(var + 1e-7) * m


def precollate(ds, device, transfer: str = "float32") -> Dict[str, Optional[torch.Tensor]]:
    """Collate every item of ``ds`` into one (N, ...) batch on ``device``.

    This freezes one realization of every item for the whole run: exactly
    the host stream for the deterministic synthetic corpus, but for a
    dataset whose items redraw crops and noise every epoch it turns that
    augmentation off, hence the warning."""
    from .dataset import SyntheticSpeechDataset

    device = torch.device(device)
    if not isinstance(ds, SyntheticSpeechDataset):
        import warnings

        warnings.warn("device-resident precollate freezes one crop/noise realization "
                      "per item for the whole run (per-epoch augmentation off); "
                      "intended for deterministic in-memory corpora", stacklevel=2)
    full = ds.collate([ds[i] for i in range(len(ds))], transfer=transfer)
    return {k: (_pinned(v, device).to(device, non_blocking=True) if v is not None else None)
            for k, v in full.items()}


def index_stream(n: int, batch_size: int, shuffle: bool = True, seed: int = 0,
                 start: int = 0) -> Iterator[np.ndarray]:
    """Endless epochs of (batch_size,) index vectors (drop-last), from batch
    ``start`` of the stream on; every stream of one seed is one sequence."""
    rng = np.random.RandomState(seed)
    b = 0
    while True:
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        for i in range(0, n - batch_size + 1, batch_size):
            if b >= start:
                yield order[i: i + batch_size]
            b += 1


def device_stream(ds, batch_size: int, device, transfer: str = "float32",
                  shuffle: bool = True, seed: int = 0, start: int = 0
                  ) -> Iterator[Dict[str, Optional[torch.Tensor]]]:
    """Endless stream of batches gathered on the device from the uploaded
    corpus, from batch ``start`` of :func:`index_stream` on."""
    if len(ds) < batch_size:
        raise ValueError(f"device_stream: dataset has {len(ds)} items < batch_size "
                         f"{batch_size}; the drop-last epoch loop would yield no batches")
    device = torch.device(device)
    data = precollate(ds, device, transfer=transfer)
    idx_gen = index_stream(len(ds), batch_size, shuffle=shuffle, seed=seed, start=start)
    return (gather_batch(data, order, device) for order in idx_gen)


def gather_batch(data: Dict[str, Optional[torch.Tensor]], order: np.ndarray,
                 device) -> Dict[str, Optional[torch.Tensor]]:
    """The rows ``order`` of the uploaded corpus ``data``, gathered on the
    device (the index vector copied from pinned memory, without a wait)."""
    device = torch.device(device)
    idx = _pinned(np.asarray(order, np.int64), device).to(device, non_blocking=True)
    return {k: (v[idx] if v is not None else None) for k, v in data.items()}


def to_device(batch: Dict[str, Optional[np.ndarray]], device,
              stream: Optional["torch.cuda.Stream"] = None):
    """Copy a collated numpy batch to ``device``: on a CUDA device through
    pinned memory, non-blocking, on ``stream``. Returns ``(batch, event)``;
    the event (None off CUDA) marks the end of the copies."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: (torch.from_numpy(v) if v is not None else None)
                for k, v in batch.items()}, None
    with torch.cuda.stream(stream):
        out = {k: (_pinned(v, device).to(device, non_blocking=True) if v is not None else None)
               for k, v in batch.items()}
        event = torch.cuda.Event()
        event.record()
    return out, event


def wait_ready(batch: Dict[str, Optional[torch.Tensor]], event) -> Dict:
    """Order the current stream after ``to_device``'s copies and tell the
    allocator that the tensors are used there."""
    if event is not None:
        cur = torch.cuda.current_stream()
        cur.wait_event(event)
        for v in batch.values():
            if v is not None:
                v.record_stream(cur)
    return batch
