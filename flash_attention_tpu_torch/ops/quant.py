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
of a weight is made; on the CPU its plain version. ``w8_matmul_group`` is
the products of weights that read the same x (q / k / v, gate / up), one
W1 launch for the group at decode.
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
# Measured (`smoke_cases.py w8_threshold`): at 16 rows W1 takes 14.2 us at wq
# against W2's 29.9 and 37.5 at w_gate against 30.8; from 24 rows W2 wins at
# w_gate by 2x (30.8 against 69.3) and loses at wq by a fifth.
W1_MAX_ROWS = 16
W1_COLS = 128  # [K, N] weights: columns a W1 strip
W1_GROUP = 3  # weights one W1 launch takes (q / k / v)
W1_BOX_STEPS = 8  # 16-row k-steps a W1 TMA box (one a consumer warp): a split takes whole boxes
W1_MAX_SPLITS = 8  # blocks a W1 cluster at most (the portable cluster size)
W1_SPLIT_STEPS = 128  # k-steps a W1 split at most, where the grid stays within W1_BLOCKS_PER_SM
W1_MIN_FILL = 0.7  # W1 splits K until the grid holds at least this many blocks a multiprocessor
W1_BLOCKS_PER_SM = 2  # ... and at most this many
W2_ROWS = (64, 128)  # x rows a W2 tile may take (the products' N)
W2_COLS = 128  # weight columns a W2 tile
W2_TILE_COST = 64  # a W2 tile's fixed cost, in x rows' worth of products (w2_plan)

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


def _x_tiles(m: int) -> int:
    """W1's 8-row x tiles a block: 1, 2 or 4."""
    return 1 if m <= 8 else (2 if m <= 16 else 4)


@functools.lru_cache(maxsize=1024)
def w1_plan(m: int, ns: tuple, k: int, sms: int = 132) -> tuple[int, int, int]:
    """W1's launch for an [M, K] x and a group of [K, N_i] weights (``ns``,
    the N of each): (8-row x tiles a block, splits of K, 16-row k-steps a
    split). A work item is a (row group, W1_COLS-column strip); K is split
    over a cluster of blocks, in whole TMA boxes of W1_BOX_STEPS k-steps:
    enough splits that the grid holds W1_MIN_FILL blocks a multiprocessor
    and no split runs past W1_SPLIT_STEPS, within W1_BLOCKS_PER_SM blocks a
    multiprocessor (a second, partial wave would take as long as the first)
    and W1_MAX_SPLITS. Measured on the card (`smoke_cases.py w1_splits`):
    fewer, longer streams beat more blocks; at ModelConfig()'s shapes q / k
    / v takes 2 splits, gate / up 1, wo 3, w_down 6."""
    xt = _x_tiles(m)
    items = math.ceil(m / (8 * xt)) * sum(math.ceil(n / W1_COLS) for n in ns)
    ksteps = math.ceil(k / 16)
    want = max(math.ceil(W1_MIN_FILL * sms / items), math.ceil(ksteps / W1_SPLIT_STEPS))
    splits = max(1, min(want, W1_MAX_SPLITS, W1_BLOCKS_PER_SM * sms // items, math.ceil(ksteps / W1_BOX_STEPS)))
    steps = math.ceil(math.ceil(ksteps / splits) / W1_BOX_STEPS) * W1_BOX_STEPS
    return xt, math.ceil(ksteps / steps), steps


def w1_work(m: int, ns, k: int, sms: int = 132) -> list[tuple[int, int, int, int, int]]:
    """The work items of ``w1_plan``'s launch as the kernel's blocks take
    them: (weight, row group, strip, first k-step, end k-step) a block, in
    block order (blockIdx.y row groups, blockIdx.x the group's strips in
    weight order times the splits, rank fastest)."""
    xt, splits, steps = w1_plan(m, tuple(ns), k, sms)
    ksteps = math.ceil(k / 16)
    items = [(i, strip) for i, n in enumerate(ns) for strip in range(math.ceil(n / W1_COLS))]
    return [(i, group, strip, rank * steps, min(ksteps, (rank + 1) * steps))
            for group in range(math.ceil(m / (8 * xt))) for i, strip in items for rank in range(splits)]


@functools.lru_cache(maxsize=1024)
def w2_plan(m: int, n: int, sms: int = 132) -> tuple[int, int]:
    """W2's launch for an [M, K] x and N output columns: (x rows a tile,
    blocks). Tiles of 64 or 128 x rows by W2_COLS weight columns, walked by
    persistent blocks, at most one a multiprocessor; the height that takes
    the fewest rounds of tiles times a tile's cost (its rows plus
    W2_TILE_COST) wins, so a few-tile shape (wq at 256 rows) takes 64-row
    tiles and fills the card."""
    cols = math.ceil(n / W2_COLS)

    def cost(bm: int) -> int:
        return math.ceil(math.ceil(m / bm) * cols / sms) * (bm + W2_TILE_COST)

    bm = min(W2_ROWS, key=lambda b: (cost(b), -b))
    return bm, min(sms, math.ceil(m / bm) * cols)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_x(what: str, x: torch.Tensor, ws, out_dtype) -> None:
    if x.device.type != "cuda" or any(w.values.device != x.device or w.scales.device != x.device for w in ws):
        raise ValueError(f"{what}: x on {x.device}, weights on {[(w.values.device, w.scales.device) for w in ws]}")
    if x.dtype not in _build.DTYPE_CODES or out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"{what}: the CUDA kernels take float32, float16 or bfloat16 x with an output of x's "
                         f"dtype or float32, got {x.dtype} -> {out_dtype}")
    for w in ws:
        if w.values.dtype != torch.int8 or w.scales.dtype != torch.float32:
            raise ValueError(f"{what}: an int8 weight with float32 scales, got {w.values.dtype} / {w.scales.dtype}")


def _operand(w: QuantizedTensor, k: int, scale_on_output: bool) -> tuple:
    """The weight as the kernels read it, over its own memory (never a
    copy): ([N, K] or [K, N] values, [N] contiguous scales, the product's
    trailing output shape). The views are skipped where the tensors already
    are what the kernels read (their host time counts at every decode
    step)."""
    out_shape = _out_shape(w.values, k, scale_on_output)
    n = math.prod(out_shape)
    values = w.values
    if not scale_on_output and values.dim() != 2:
        try:
            values = values.view(k, n)
        except RuntimeError as err:
            raise ValueError(f"w8_matmul: the weight {tuple(w.values.shape)} with strides {w.values.stride()} is no "
                             f"[K, N] view") from err
    scales = w.scales
    if scales.numel() != n:
        raise ValueError(f"w8_matmul: {scales.numel()} scales for {n} output channels")
    if values.stride(1) != 1 and values.shape[1] > 1:
        raise ValueError(f"w8_matmul: the weight's last axis must be contiguous, strides {values.stride()}")
    return values, scales if scales.is_contiguous() else scales.contiguous(), out_shape


def _ld(t: torch.Tensor) -> int:
    """A 2-D operand's leading pitch (its row length for a single row)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _vec(x2: torch.Tensor, *weights: torch.Tensor) -> bool:
    """Whether W1 reads x by whole 16-byte vectors and the weights by TMA
    (else byte by byte, a strided shard's odd pitch for instance)."""
    return (x2.shape[1] % 16 == 0 and _ld(x2) % 8 == 0 and _aligned(x2)
            and all(v.shape[1] % 16 == 0 and _ld(v) % 16 == 0 and _aligned(v) for v in weights))


def _takes_w2(x2: torch.Tensor, values: torch.Tensor) -> bool:
    """16-bit x of more than W1_MAX_ROWS rows whose operands TMA takes."""
    return (x2.dtype != torch.float32 and x2.shape[0] > W1_MAX_ROWS and x2.shape[1] % 8 == 0
            and _ld(x2) % 8 == 0 and _ld(values) % 16 == 0 and _aligned(x2, values))


def _launch_w2(x2, values, scales, out, scale_on_output: bool, plan=None) -> None:
    """W2 on one weight; ``plan`` (tile rows, blocks) in place of
    ``w2_plan``'s, for a measurement."""
    m, k = x2.shape
    n = out.shape[1]
    bm, grid = plan or w2_plan(m, n, _sms(x2.device.index or 0))
    shape = (m, n, k, _ld(x2), _ld(values), n, int(scale_on_output), int(not scale_on_output),
             int(out.dtype == torch.float32), 2, 1, 1, bm, grid)
    with _build.on_device(x2.device):
        err = _build.kernels().fat_w8_matmul(x2.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
                                             _build.int64_tuple_array(shape), _build.DTYPE_CODES[x2.dtype],
                                             _build.current_stream(x2.device))
    _build.check(err, f"w8_matmul (W2, x {x2.dtype} (M, N, K, ldx, ldw, ldo, nk, scaled, out_f32, kernel, tiles, "
                      f"vec, bm, grid) {shape})")
    w8_matmul.w2_launches += 1


def _launch_w1(x2, values, scales, out, scale_on_output: bool) -> None:
    """W1 on one weight: the FMA body (fp32 x) or the [N, K] body (16-bit x,
    the unembed); a 16-bit [K, N] product goes through ``_launch_w1_group``."""
    m, k = x2.shape
    n = out.shape[1]
    shape = (m, n, k, _ld(x2), _ld(values), n, int(scale_on_output), int(not scale_on_output),
             int(out.dtype == torch.float32), 1, _x_tiles(m), int(_vec(x2, values)), 0, 0)
    with _build.on_device(x2.device):
        err = _build.kernels().fat_w8_matmul(x2.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
                                             _build.int64_tuple_array(shape), _build.DTYPE_CODES[x2.dtype],
                                             _build.current_stream(x2.device))
    _build.check(err, f"w8_matmul (W1, x {x2.dtype} (M, N, K, ldx, ldw, ldo, nk, scaled, out_f32, kernel, tiles, "
                      f"vec, bm, grid) {shape})")
    w8_matmul.w1_launches += 1


def _launch_w1_group(x2, operands, outs, plan=None, ns=None) -> None:
    """W1 on up to W1_GROUP [K, N_i] weights (``operands``: (values, scales)
    each) that read the 16-bit x2, into ``outs`` (contiguous, [m, N_i] or
    any shape of as many elements; ``ns`` their N_i), in one launch;
    ``plan`` (x tiles, splits, steps) in place of ``w1_plan``'s, for a
    measurement."""
    m, k = x2.shape
    ns = tuple(ns) if ns is not None else tuple(o.shape[1] for o in outs)
    xt, splits, steps = plan or w1_plan(m, ns, k, _sms(x2.device.index or 0))
    vec = _vec(x2, *(values for values, _ in operands))
    out_f32 = int(outs[0].dtype == torch.float32)
    shape = (len(ns), m, k, _ld(x2), 1, out_f32, xt, splits, steps, int(vec),
             *(v for (values, _), n in zip(operands, ns) for v in (n, _ld(values), n)))
    ptrs = [p for (values, scales), out in zip(operands, outs) for p in (values.data_ptr(), scales.data_ptr(),
                                                                          out.data_ptr())]
    with _build.on_device(x2.device):
        err = _build.kernels().fat_w8_group(x2.data_ptr(), _build.int64_array(ptrs), _build.int64_tuple_array(shape),
                                            _build.DTYPE_CODES[x2.dtype], _build.current_stream(x2.device))
    _build.check(err, f"w8_matmul_group (W1, x {x2.dtype} (count, M, K, ldx, scaled, out_f32, tiles, splits, steps, "
                      f"vec, then (N, ldw, ldo) a weight) {shape})")
    w8_matmul.w1_launches += 1


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
    come from ``torch.empty``; nothing synchronises, so both run inside CUDA
    graphs."""
    if x.device.type == "cpu" and w.values.device.type == "cpu":
        return w8_matmul_plain(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_x("w8_matmul", x, (w,), out_dtype)
    k = x.shape[-1]
    values, scales, out_shape = _operand(w, k, scale_on_output)
    x2 = _build.unit_last_stride(x.reshape(-1, k))
    m, n = x2.shape[0], math.prod(out_shape)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        if _takes_w2(x2, values):
            _launch_w2(x2, values, scales, out, scale_on_output)
        elif scale_on_output or x2.dtype == torch.float32:
            _launch_w1(x2, values, scales, out, scale_on_output)
        else:
            _launch_w1_group(x2, [(values, scales)], [out])
    return out.reshape(*x.shape[:-1], *out_shape)


def w8_matmul_group(x: torch.Tensor, ws, *, out_dtype=None) -> tuple:
    """``w8_matmul(x, w, out_dtype=out_dtype)`` for each layer weight of
    ``ws`` (scale on the weight), which all read the same x: a tuple of
    their products. On the card one W1 launch takes the whole group (16-bit
    x of at most W1_MAX_ROWS rows, at most W1_GROUP weights), each weight
    with its own pointer, stride, scales and output, so nothing is
    concatenated or copied; otherwise each weight takes ``w8_matmul``'s
    kernel. On the CPU the per-weight ``w8_matmul_plain``."""
    ws = tuple(ws)
    if x.device.type == "cpu" and all(w.values.device.type == "cpu" for w in ws):
        return tuple(w8_matmul_plain(x, w, out_dtype=out_dtype) for w in ws)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    k = x.shape[-1]
    x2 = _build.unit_last_stride(x.reshape(-1, k))
    m = x2.shape[0]
    if x.dtype == torch.float32 or m > W1_MAX_ROWS or len(ws) > W1_GROUP or m == 0:
        return tuple(w8_matmul(x, w, out_dtype=out_dtype) for w in ws)
    _check_x("w8_matmul_group", x, ws, out_dtype)
    operands = [_operand(w, k, False) for w in ws]
    # One allocation for the group, each output a contiguous [m, N_i] piece of it.
    ns = [math.prod(shape) for _, _, shape in operands]
    flat = torch.empty(m * sum(ns), dtype=out_dtype, device=x.device)
    outs, off = [], 0
    for n, (_, _, shape) in zip(ns, operands):
        outs.append(flat[off:off + m * n].view(*x.shape[:-1], *shape))
        off += m * n
    live = [i for i, n in enumerate(ns) if n]
    if live:
        _launch_w1_group(x2, [operands[i][:2] for i in live], [outs[i] for i in live], ns=[ns[i] for i in live])
    return tuple(outs)


counter(w8_matmul, "w1_launches", "W1", "w8_gemv_kernel", "w8_gemv_group_kernel", "w8_gemv_fma_kernel")
counter(w8_matmul, "w2_launches", "W2", "w8_gemm_kernel")
