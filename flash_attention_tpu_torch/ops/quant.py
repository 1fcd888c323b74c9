"""KV-cache and weight quantization: int8 / fp8 payloads with fp32 scales.

Counterpart of the JAX package's ``ops/quant.py``, in plain PyTorch (the JAX
package has no kernel here either). A KV cache stores its rows as a payload
``[..., S, D]`` in int8, ``float8_e4m3fn`` or ``float8_e5m2`` beside fp32
scales ``[..., S, 1]``, one per cached row and head; the decode and paged
kernels (csrc/decode.cu, csrc/flash_fwd.cu) read the payload and multiply
by the row's scale as they load it, and the paged write (csrc/paged_write.cu)
quantizes as it writes. Payloads and scales are bit-equal to the JAX
package's for fp32 and bf16 inputs: the scale is absmax / 127 (int8) or
absmax / the format's largest finite value (fp8), computed in fp32 and 1 for
an all-zero row; int8 rounds half to even (``torch.round``, as
``jnp.round``) and clips to [-127, 127]; fp8 is a plain cast.

Weights (W8A16): ``quantize_weight`` stores a matmul weight as int8 with one
fp32 scale per output channel, and ``w8_dequant`` widens it to bf16 at the
matmul, as the JAX package does, whatever the model's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAYLOADS = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


class QuantizedTensor(NamedTuple):
    """A quantized payload and its broadcastable fp32 scales."""

    values: torch.Tensor  # [..., S, D] int8 / float8
    scales: torch.Tensor  # [..., S, 1] float32

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device


def payload_dtype(mode: str):
    """Storage dtype of a KV quant mode; None for mode 'none'."""
    if mode == "none":
        return None
    if mode not in PAYLOADS:
        raise ValueError(f"unknown quantization mode {mode!r}")
    return PAYLOADS[mode]


def payload_max(payload: torch.dtype) -> float:
    """The value an absmax row element maps to: 127 for int8, else the fp8
    format's largest finite value."""
    return 127.0 if payload == torch.int8 else float(torch.finfo(payload).max)


def _scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    # Divide by a tensor: given a Python number, PyTorch's CUDA division
    # multiplies by its reciprocal instead, which can differ in the last bit.
    return torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / torch.full_like(absmax, qmax))


def quantize_int8(x: torch.Tensor, *, axis: int = -1) -> QuantizedTensor:
    """Symmetric int8 quantization, one scale per row over ``axis``."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=axis, keepdim=True), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def quantize_fp8(x: torch.Tensor, *, axis: int = -1, dtype=torch.float8_e4m3fn) -> QuantizedTensor:
    """fp8 quantization: each row over ``axis`` scaled onto the format's
    finite range."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=axis, keepdim=True), payload_max(dtype))
    return QuantizedTensor((xf / scale).to(dtype), scale)


def quantize_values(x: torch.Tensor, payload: torch.dtype) -> QuantizedTensor:
    """Per-row (last dim) quantization to an explicit payload dtype."""
    if payload == torch.int8:
        return quantize_int8(x)
    return quantize_fp8(x, dtype=payload)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, mode: str):
    """Quantize K and V per row; mode in {'int8', 'fp8_e4m3', 'fp8_e5m2', 'none'}."""
    payload = payload_dtype(mode)
    if payload is None:
        return k, v
    return quantize_values(k, payload), quantize_values(v, payload)


def bits(x: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor viewed as uint8 (the same bytes, any strides), any
    other tensor as it is: indexing, index assignment and ``torch.where``
    on it then need no float8 kernel."""
    return x.view(torch.uint8) if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else x


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.values.float() * qt.scales).to(dtype)


def quantize_weight(w: torch.Tensor, *, contract_axes) -> QuantizedTensor:
    """Weight-only symmetric int8 (W8A16), one scale per OUTPUT channel:
    the absmax runs over ``contract_axes`` (the axes the matmul contracts),
    which the scales keep with size 1 so ``values * scales`` broadcasts."""
    dims = contract_axes if isinstance(contract_axes, (tuple, list)) else (contract_axes,)
    xf = w.float()
    scale = _scale(xf.abs().amax(dim=tuple(d % w.ndim for d in dims), keepdim=True), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def w8_dequant(w, dtype=torch.bfloat16):
    """A tensor as it is, or a QuantizedTensor widened to ``dtype`` (bf16 by
    default, as every call site in the JAX package leaves it)."""
    if isinstance(w, QuantizedTensor):
        return w.values.to(dtype) * w.scales.to(dtype)
    return w
