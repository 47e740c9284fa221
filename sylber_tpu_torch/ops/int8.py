"""Dynamic W8A8 int8 products: the int8 serving mode of the encoder.

Port of ``sylber_tpu/ops/int8.py``: weights quantized per output channel,
activations per token, both symmetric (scale ``max|x| / 127``, values
``clip(round_half_even(x / scale), -127, 127)``), the product in int8 with
int32 sums, then ``(acc * sx) * sw + b`` in float32, rounded to the output
dtype. Weights keep torch's ``nn.Linear`` layout (N, K), where JAX's (K, N)
kernel is quantized along axis 0: here that is a per-row quantization, so
one row quantizer serves the activations and the weights.

On a CUDA tensor :func:`quantize_rows` and :func:`int8_gemm` launch the
kernels of ``csrc/int8_gemm.cu`` (its header says what bounds them and how
the design answers that); on a CPU tensor they run the plain versions,
:func:`quantize_symmetric_plain` and :func:`int8_gemm_plain`. The plain
product is taken exactly in float64 (exact while K * 127^2 < 2^53) and
converted to float32, which rounds an integer as the int32 conversion does.
The encoder quantizes its weights once per load, not in every forward as
JAX does in its graph (the outputs are the same): :class:`QuantizedWeights`
keeps each weight group's int8 operand and scales while the weights are
unchanged (its docstring says what it checks).

Inference only: the rounding has no gradient (JAX's trainer refuses the
mode, and so does the port's).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels import check, device_of, lib, require_cuda, stream_of

MIN_AMAX = 1e-8
QMAX = 127.0
ROW_ALIGN = 16  # bytes: the GEMM's TMA loads take row strides in multiples of 16
_DTYPES = (torch.float32, torch.bfloat16)


def quantize_symmetric_plain(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``q`` int8 like ``x``, ``scale`` float32 reduced over
    ``dim`` with the dim kept (JAX ``quantize_symmetric``, ``axis=dim``)."""
    x = x.float()
    amax = x.abs().amax(dim, keepdim=True).clamp_min(MIN_AMAX)
    # divide by a tensor: torch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the IEEE quotient JAX takes
    scale = amax / torch.full_like(amax, QMAX)
    q = torch.round(x / scale).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale


def int8_gemm_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                    bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """(M, N) ``((xq . wq^T) * sx) * sw + bias`` in ``out_dtype``; ``xq``
    (M, K) and ``wq`` (N, K) int8, ``sx`` (M,), ``sw`` (N,) float32."""
    acc = (xq.double() @ wq.double().T).float()
    y = acc * sx.float()[:, None] * sw.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_dense_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` under dynamic W8A8, JAX ``int8_dense``'s
    arithmetic; ``x`` (..., K), ``weight`` (N, K)."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_symmetric_plain(x.reshape(-1, x.shape[-1]))
    wq, sw = quantize_symmetric_plain(weight)
    y = int8_gemm_plain(xq, sx[:, 0], wq, sw[:, 0], bias, out_dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def padded_width(K: int) -> int:
    """The row stride, in int8 values, of a quantized (R, K) buffer."""
    return -(-K // ROW_ALIGN) * ROW_ALIGN


def quantize_rows(x: torch.Tensor, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of a 2-D ``x`` (R, K), float32
    or bfloat16: ``(q (R, K) int8, scale (R,) float32)``, bit-equal to
    :func:`quantize_symmetric_plain` along the last dim.

    On CUDA ``q`` is a view of an (R, :func:`padded_width`) buffer whose
    columns past K are zero (what :func:`int8_gemm` takes); ``out`` names
    that buffer's rows to fill (a row slice of a larger buffer, and the
    matching slice of its scales)."""
    R, K = x.shape
    if x.device.type == "cpu":
        q, s = quantize_symmetric_plain(x)
        if out is None:
            return q, s[:, 0]
        out[0][:, :K].copy_(q)
        out[1].copy_(s[:, 0])
        return out[0][:, :K], out[1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_rows: x must be float32 or bfloat16, got {x.dtype}")
    require_cuda("quantize_rows", x, contiguous=False)
    if x.stride(1) != 1:
        x = x.contiguous()
    if out is None:
        q = torch.empty(R, padded_width(K), dtype=torch.int8, device=x.device)
        s = torch.empty(R, dtype=torch.float32, device=x.device)
    else:
        q, s = out
        if (q.dtype != torch.int8 or q.shape[0] != R or q.shape[1] < K or q.stride(1) != 1
                or q.stride(0) != q.shape[1] or q.shape[1] % ROW_ALIGN or q.data_ptr() % 16
                or s.shape != (R,) or s.dtype != torch.float32 or not s.is_contiguous()):
            raise ValueError("quantize_rows: out must be an (R, padded_width(K)) int8 row "
                             "slice and an (R,) float32 scale")
        require_cuda("quantize_rows", x, q, s, contiguous=False)
    _launch_quantize(x, q, s)
    return q[:, :K], s


def _launch_quantize(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    R, K = x.shape
    v = 16 // x.element_size()  # values a 16-byte load
    vec = K % v == 0 and x.stride(0) % v == 0 and x.data_ptr() % 16 == 0
    with device_of(x):
        check(lib().sylber_quantize_rows(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), R, K, x.stride(0), q.stride(0),
            int(x.dtype == torch.bfloat16), int(vec), stream_of(x)), "quantize_rows")
    quantize_rows.launches += 1


quantize_rows.launches = 0


def quantize_weights(weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N_i, K) weights quantized row by row into one (sum N_i, K) int8
    operand and its scales: with per-output-channel scales this equals
    quantizing their concatenation, without the float copy."""
    K = weights[0].shape[1]
    if len(weights) == 1:
        return quantize_rows(weights[0])
    N, dev = sum(w.shape[0] for w in weights), weights[0].device
    q = torch.empty(N, padded_width(K), dtype=torch.int8, device=dev)
    s = torch.empty(N, dtype=torch.float32, device=dev)
    r = 0
    for w in weights:
        quantize_rows(w, out=(q[r:r + w.shape[0]], s[r:r + w.shape[0]]))
        r += w.shape[0]
    return q[:, :K], s


class QuantizedWeights:
    """The int8 operands of a module's weights, kept across calls:
    ``cache(name, weights)`` is :func:`quantize_weights` of ``weights``,
    taken again only when one of them changed since the last call under
    ``name``.

    A weight is the same while its ``data_ptr()``, ``_version``, device,
    dtype, shape and strides are: ``load_state_dict`` and ``param.copy_``
    write in place and bump ``_version``; ``.to(dtype or device)`` gives
    new storage. The quantized sources are held (detached, sharing the
    parameters' storage), so their addresses are not handed to other
    tensors while a key names them. A write through ``.data`` (``w.data.
    copy_(...)``) does not bump the parameter's ``_version`` and is not
    seen: nothing on the int8 path writes so. A plain attribute of the
    module, not a buffer: ``state_dict`` and the parameter tree are
    unchanged, and a deep copy starts empty."""

    def __init__(self):
        self._entries: Dict[str, tuple] = {}

    def __call__(self, name: str, weights: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = tuple((w.data_ptr(), w._version, w.device, w.dtype, w.shape, w.stride())
                    for w in weights)
        entry = self._entries.get(name)
        if entry is None or entry[0] != key:
            held = [w.detach() for w in weights]
            entry = self._entries[name] = (key, held, quantize_weights(held))
        return entry[2]

    def __deepcopy__(self, memo):
        return QuantizedWeights()


def int8_gemm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, N) ``((xq . wq^T) * sx) * sw + bias`` in ``out_dtype`` (float32
    or bfloat16); ``xq`` (M, K), ``wq`` (N, K) int8 as :func:`quantize_rows`
    leaves them, ``sx`` (M,), ``sw`` (N,) float32, ``bias`` (N,) or None.
    ``out``: an (M, N) view with a dense last dimension to write into."""
    if xq.device.type == "cpu":
        y = int8_gemm_plain(xq, sx, wq, sw, bias, out_dtype)
        return y if out is None else out.copy_(y)
    (M, K), N = xq.shape, wq.shape[0]
    if out_dtype not in _DTYPES:
        raise ValueError(f"int8_gemm: out_dtype must be float32 or bfloat16, got {out_dtype}")
    for name, t in (("xq", xq), ("wq", wq)):
        if (t.dtype != torch.int8 or t.shape[1] != K or t.stride(1) != 1
                or t.stride(0) % ROW_ALIGN or t.stride(0) < padded_width(K)
                or t.data_ptr() % 16):
            raise ValueError(f"int8_gemm: {name} must be int8 (rows, {K}) with a row stride "
                             f"that is a multiple of {ROW_ALIGN} (zeros past K), 16-byte "
                             "aligned, as quantize_rows leaves it")
    if sx.shape != (M,) or sw.shape != (N,) or (bias is not None and bias.shape != (N,)):
        raise ValueError("int8_gemm: sx (M,), sw (N,) and bias (N,) expected")
    vecs = [t.float().contiguous() for t in (sx, sw)]
    bias = None if bias is None else bias.float().contiguous()
    if out is None:
        out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
    elif out.shape != (M, N) or out.dtype != out_dtype or out.stride(1) != 1:
        raise ValueError(f"int8_gemm: out must be ({M}, {N}) {out_dtype} with a dense last dim")
    require_cuda("int8_gemm", xq, wq, *vecs, out, *([] if bias is None else [bias]),
                 contiguous=False)
    _launch_gemm(xq, vecs[0], wq, vecs[1], bias, out)
    return out


def _launch_gemm(xq, sx, wq, sw, bias, out) -> None:
    (M, K), N = xq.shape, wq.shape[0]
    with device_of(xq):
        check(lib().sylber_int8_gemm(
            xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K, xq.stride(0),
            wq.stride(0), out.stride(0), int(out.dtype == torch.bfloat16), stream_of(xq)),
            "int8_gemm")
    int8_gemm.launches += 1


int8_gemm.launches = 0


def int8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """``x`` (..., K) quantized per row, times the quantized weight
    (:func:`quantize_weights`): (..., N) in ``out_dtype``."""
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    y = int8_gemm(xq, sx, wq, sw, bias, out_dtype)
    return y.view(*x.shape[:-1], wq.shape[0])


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` under dynamic W8A8 (JAX ``int8_dense`` with
    the (N, K) weight of ``nn.Linear``): both operands quantized in this
    call, the product on the kernels for CUDA tensors."""
    wq, sw = quantize_rows(weight)
    return int8_linear(x, wq, sw, bias, out_dtype or x.dtype)
