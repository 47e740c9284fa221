"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``)."""

from __future__ import annotations

import torch

from ._build import BUILD_DIR, build, check, lib

__all__ = ["BUILD_DIR", "build", "check", "device_of", "lib", "stream_of", "require_cuda"]


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream on ``t``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def device_of(t: torch.Tensor) -> torch.cuda.device:
    """``t``'s card made current for a ``with`` block around a launch:
    CUDA launches a kernel, and sets its attributes, on the current device,
    whatever card the stream passed belongs to (a replica on ``cuda:1``
    while ``cuda:0`` is current). Does nothing for a CPU tensor."""
    return torch.cuda.device(t.get_device())


def require_cuda(name: str, *tensors: torch.Tensor, contiguous: bool = True) -> None:
    """Raise unless every tensor is a CUDA tensor on one device, and
    contiguous unless the kernel takes strides."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {[str(x.device) for x in tensors]}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
