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
fp32 scale per output channel, and ``w8_dequant`` widens it to bf16, as the
JAX package does, whatever the model's dtype. ``w8_matmul`` is the product
with such a weight that the JAX package leaves XLA to fuse (the widen inside
the dot's weight read): on the card kernels W1 and W2 (csrc/w8.cu) read the
int8 payload and widen it in registers or shared memory, so no 16-bit copy
of a weight is made; on the CPU its plain version.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.counters import counter

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


# ---- W8A16 products: W1 and W2 (csrc/w8.cu) ----

# Rows of x (B * T) at most that take W1, the weight-stream kernel; more take
# W2, the wgmma GEMM (16-bit activations; fp32 takes W1's FMA body at any M).
W1_MAX_ROWS = 32
W1_COLS = 128  # [K, N] weights: columns a W1 block
W1_BLOCKS_PER_SM = 2  # W1 splits K over blocks until the card holds about this many a streaming multiprocessor
W1_MIN_STEPS = 32  # 16-row k-steps a split at least
_TICKETS: dict = {}
# Ticket buffers that a larger one replaced: a captured CUDA graph keeps the
# address of the one it launched with for its life.
_RETIRED_TICKETS: list = []


def _out_shape(values: torch.Tensor, k: int, scale_on_output: bool) -> tuple:
    """The product's trailing output shape: [N] for the [N, K] embedding,
    else the axes of ``values`` after the fewest leading ones whose sizes
    multiply to x's last axis, ``k``."""
    if scale_on_output:
        if values.ndim != 2 or values.shape[1] != k:
            raise ValueError(f"w8_matmul: scale_on_output takes [N, K] values with K = {k}, got "
                             f"{tuple(values.shape)}")
        return tuple(values.shape[:1])
    size = 1
    for axes in range(1, values.ndim + 1):
        size *= values.shape[axes - 1]
        if size == k:
            return tuple(values.shape[axes:])
    raise ValueError(f"w8_matmul: no leading axes of the weight {tuple(values.shape)} hold x's {k} columns")


def w8_matmul_plain(x: torch.Tensor, w: QuantizedTensor, *, out_dtype=None, scale_on_output: bool = False):
    """The function W1 and W2 compute, in plain PyTorch (the wrapper's CPU
    path; differentiable in x). Scale on the weight: ``w8_dequant(w)`` in x's
    dtype (through bf16, as ``_weight`` widens it) over ``w.values``'
    leading axes that hold x's last axis; scale on the output (the tied
    unembed): x times the [N, K] codes, the sum times the row's fp32 scale,
    as the JAX package's ``preferred_element_type=float32`` product. The
    products of the 16-bit operands are exact in fp32 and summed in fp32,
    rounded once to ``out_dtype`` (x's by default)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    k = x.shape[-1]
    out_shape = _out_shape(w.values, k, scale_on_output)
    if scale_on_output:
        prod = torch.matmul(x.float(), w.values.to(x.dtype).float().t())
        return (prod * w.scales.reshape(-1).float()).to(out_dtype)
    wide = w8_dequant(w).to(x.dtype).reshape(k, -1)
    return torch.matmul(x.float(), wide.float()).to(out_dtype).reshape(*x.shape[:-1], *out_shape)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def w1_plan(m: int, n: int, k: int, nk: bool, sms: int = 132) -> tuple[int, int, int]:
    """W1's launch for an [M, K] x and an [N, K] (``nk``) or [K, N] weight:
    (8-row x tiles a block, splits of K, 16-row k-steps a split). A [K, N]
    weight of N / 128 column strips splits K into as many parts as keep the
    grid within one wave of W1_BLOCKS_PER_SM blocks a multiprocessor (a
    second, partial wave would take as long as the first), with at least
    W1_MIN_STEPS k-steps a split (the partials' write and reduction cost
    more than thinner splits gain: at ModelConfig()'s wk, 8 splits took
    12.3 us, 32 took 15.0, `smoke_cases.py w1_splits`); an [N, K] one (a
    warp a 16 rows) never."""
    xt = 1 if m <= 8 else (2 if m <= 16 else 4)
    if nk:
        return xt, 1, 1
    groups = math.ceil(m / (8 * xt))
    strips = math.ceil(n / W1_COLS)
    ksteps = math.ceil(k / 16)
    splits = max(1, min(W1_BLOCKS_PER_SM * sms // (strips * groups), ksteps // W1_MIN_STEPS))
    steps = math.ceil(ksteps / splits)
    return xt, math.ceil(ksteps / steps), steps


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` counters kept per device;
    every W1 launch leaves the counters it used at 0."""
    tickets = _TICKETS.get(device)
    if tickets is None or tickets.numel() < n:
        if tickets is not None:
            _RETIRED_TICKETS.append(tickets)
        tickets = _TICKETS[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return tickets


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def w8_matmul(x: torch.Tensor, w: QuantizedTensor, *, out_dtype=None, scale_on_output: bool = False):
    """x [..., K] times the int8 weight ``w`` widened as the JAX package's
    fused ``w8_dequant`` widens it, with fp32 accumulation, in ``out_dtype``
    (x's by default; float32 for the unembed and the row-parallel partial).

    ``scale_on_output`` False (every layer weight): ``w.values`` [K..., N...]
    contracted over its leading axes that hold x's K (wq [M, H, D] over M, wo
    [H, D, M] over (H, D)), the scales (one an output channel) applied to the
    weight; returns [..., N...]. True (the tied unembed): ``w.values`` [N, K]
    and ``w.scales`` [N, 1], the scale applied to the fp32 sum; returns
    [..., N]. The weight is read in place, a strided view (a
    tensor-parallel shard) included: N (or K for [N, K]) contiguous, any
    leading stride.

    CPU tensors take ``w8_matmul_plain``. CUDA tensors take W1 (16-bit x at
    most W1_MAX_ROWS rows, or fp32 x at any rows) or W2 (16-bit x of more
    rows, where TMA takes its operands: 16-byte aligned, K a multiple of 8,
    the weight's leading stride a multiple of 16; else W1), counted as
    ``.w1_launches`` / ``.w2_launches``; a launch that fails raises. Outputs
    and W1's split workspace come from ``torch.empty``; nothing
    synchronises, so both run inside CUDA graphs."""
    if x.device.type == "cpu" and w.values.device.type == "cpu":
        return w8_matmul_plain(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type != "cuda" or w.values.device != x.device or w.scales.device != x.device:
        raise ValueError(f"w8_matmul: x on {x.device}, weight on {w.values.device} / {w.scales.device}")
    if x.dtype not in _build.DTYPE_CODES or out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"w8_matmul: the CUDA kernels take float32, float16 or bfloat16 x with an output of x's "
                         f"dtype or float32, got {x.dtype} -> {out_dtype}")
    if w.values.dtype != torch.int8 or w.scales.dtype != torch.float32:
        raise ValueError(f"w8_matmul: an int8 weight with float32 scales, got {w.values.dtype} / {w.scales.dtype}")
    k = x.shape[-1]
    out_shape = _out_shape(w.values, k, scale_on_output)
    n = math.prod(out_shape)
    try:  # [N, K] or [K, N] over the weight's own memory: never a copy
        values = w.values if scale_on_output else w.values.view(k, n)
    except RuntimeError as err:
        raise ValueError(f"w8_matmul: the weight {tuple(w.values.shape)} with strides {w.values.stride()} is no "
                         f"[K, N] view") from err
    scales = w.scales.reshape(-1)
    if scales.numel() != n:
        raise ValueError(f"w8_matmul: {scales.numel()} scales for {n} output channels")
    scales = scales.contiguous()
    if values.stride(1) != 1 and values.shape[1] > 1:
        raise ValueError(f"w8_matmul: the weight's last axis must be contiguous, strides {values.stride()}")
    x2 = _build.unit_last_stride(x.reshape(-1, k))
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        ldx, ldw = x2.stride(0) if m > 1 else k, values.stride(0) if values.shape[0] > 1 else values.shape[1]
        tma = k % 8 == 0 and ldx % 8 == 0 and ldw % 16 == 0 and _aligned(x2, values)
        vec = k % 16 == 0 and n % 16 == 0 and ldx % 8 == 0 and ldw % 16 == 0 and _aligned(x2, values)
        fma = x.dtype == torch.float32  # W1's FMA body: a thread a column, no split
        w2 = not fma and m > W1_MAX_ROWS and tma
        xt, splits, steps = (1, 1, 1) if fma else w1_plan(m, n, k, scale_on_output, _sms(x.device.index or 0))
        ws = tickets = None
        if not w2 and splits > 1:
            groups, strips = math.ceil(m / (8 * xt)), math.ceil(n / W1_COLS)
            ws = torch.empty(groups * strips * splits * xt * 1024, dtype=torch.float32, device=x.device)
            tickets = _tickets(x.device, groups * strips)
        shape = (m, n, k, ldx, ldw, n, int(scale_on_output), int(not scale_on_output), int(out_dtype == torch.float32),
                 2 if w2 else 1, xt, splits, steps, int(vec))
        with _build.on_device(x.device):
            err = _build.kernels().fat_w8_matmul(
                x2.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(),
                _build.int64_tuple_array(shape), _build.DTYPE_CODES[x.dtype], _build.current_stream(x.device))
        _build.check(err, f"w8_matmul ({'W2' if w2 else 'W1'}, x {x.dtype} (M, N, K, ldx, ldw, ldo, nk, scaled, out_f32, "
                          f"kernel, tiles, splits, steps, vec) {shape})")
        if w2:
            w8_matmul.w2_launches += 1
        else:
            w8_matmul.w1_launches += 1
    return out.reshape(*x.shape[:-1], *out_shape)


counter(w8_matmul, "w1_launches", "W1", "w8_gemv_kernel", "w8_gemv_fma_kernel")
counter(w8_matmul, "w2_launches", "W2", "w8_gemm_kernel")
