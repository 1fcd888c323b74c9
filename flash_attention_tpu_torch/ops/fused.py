"""The decode step's elementwise glue: kernels F1-F3 (csrc/fused.cu) and
their plain versions.

In the JAX package the decode block is one XLA program, and XLA fuses the
glue between its matmuls and attention kernels; eager PyTorch issued each
piece as 5-15 launches. These are hand-written kernels for those fusions
(no Pallas kernel is replaced):

  * ``add_rms_norm`` (F1) — the residual add and the RMSNorm after it
    (JAX ``models/transformer.py:86-89``, residuals ``:211-218``);
  * ``rope`` (F2) — RoPE on q and k in one launch (JAX ``models/rope.py``),
    and, at T == 1 over a dense KV cache, the cache row write of the rotated
    k and the new v by ``write_cache``'s rules (JAX
    ``models/attention.py:146``), quantized into a quantized cache;
  * ``swiglu_act`` (F3) — silu(gate) * up (JAX ``models/transformer.py:103``).

The paged decode's self term (JAX ``attention_decode_paged_deferred``) is
K7's (``ops/paged.paged_decode_attention(self_kv=...)``).

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors, with no fallback from one to the other, and counts
its launches (``.launches``, registered in ``ops/counters.py`` as F1, F2,
F3). A wrapper allocates its outputs with ``torch.empty`` and synchronises
nothing, so each runs inside the decode programs' CUDA graphs. What bounds
the kernels and their design: csrc/fused.cu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.models.rope import apply_rope, rope_table
from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import ceil_to
from flash_attention_tpu_torch.ops.counters import counter
from flash_attention_tpu_torch.ops.quant import bits, quantize_values


def _on_card(what: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what}: the CUDA kernel takes float32, float16 or bfloat16, got {x.dtype}")
    return True


def _same(what: str, x: torch.Tensor, *others) -> None:
    for t in others:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: operands differ in dtype or device ({x.dtype} on {x.device} vs {t.dtype} on "
                             f"{t.device})")


# ---- F1 ----

def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float):
    """(the norm of x in x's dtype, its fp32 rstd [..., 1])."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def add_rms_norm_plain(x: torch.Tensor, delta, weight: torch.Tensor, eps: float):
    """The function F1 computes: (x_new, h)."""
    x_new = x if delta is None else x + delta
    return x_new, rms_norm_plain(x_new, weight, eps)[0]


def add_rms_norm(x: torch.Tensor, delta, weight: torch.Tensor, eps: float):
    """The residual add and RMSNorm over the last dim: x_new = x + delta in
    x's dtype (x itself when ``delta`` is None), h = x_new * rsqrt(mean of
    x_new^2 + eps) * weight with the sum of squares, the rsqrt and the
    weight in fp32, cast to x's dtype. Returns (x_new, h). On the card one
    launch (F1); ``delta`` and ``weight`` of x's dtype."""
    if not _on_card("add_rms_norm", x):
        return add_rms_norm_plain(x, delta, weight, eps)
    width = x.shape[-1]
    _same("add_rms_norm", x, weight, *(() if delta is None else (delta,)))
    if weight.shape != (width,) or (delta is not None and delta.shape != x.shape):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)}, delta {None if delta is None else tuple(delta.shape)}, "
                         f"weight {tuple(weight.shape)}")
    x, weight = x.contiguous(), weight.contiguous()
    delta = None if delta is None else delta.contiguous()
    x_new = x if delta is None else torch.empty_like(x)
    h = torch.empty_like(x)
    rows = x.numel() // width if width else 0
    if rows:
        with _build.on_device(x.device):
            err = _build.kernels().fat_add_rms_norm(
                x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(), x_new.data_ptr(),
                h.data_ptr(), rows, width, float(eps), _build.DTYPE_CODES[x.dtype], _build.current_stream(x.device))
        _build.check(err, "add_rms_norm (F1)")
        add_rms_norm.launches += 1
    return x_new, h


counter(add_rms_norm, "launches", "F1", "add_rms_norm_kernel")


# ---- F3 ----

def swiglu_act_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def swiglu_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in fp32, rounded to gate's dtype; on the card one
    launch (F3), ``up`` of gate's dtype and shape."""
    if not _on_card("swiglu_act", gate):
        return swiglu_act_plain(gate, up)
    _same("swiglu_act", gate, up)
    if up.shape != gate.shape:
        raise ValueError(f"swiglu_act: gate {tuple(gate.shape)} vs up {tuple(up.shape)}")
    gate, up = gate.contiguous(), up.contiguous()
    out = torch.empty_like(gate)
    if out.numel():
        with _build.on_device(gate.device):
            err = _build.kernels().fat_swiglu_act(gate.data_ptr(), up.data_ptr(), out.data_ptr(), out.numel(),
                                                  _build.DTYPE_CODES[gate.dtype], _build.current_stream(gate.device))
        _build.check(err, "swiglu_act (F3)")
        swiglu_act.launches += 1
    return out


counter(swiglu_act, "launches", "F3", "swiglu_act_kernel")


# ---- F2 ----

def write_row_plain(cache, k_new: torch.Tensor, v_new: torch.Tensor, start: torch.Tensor, *, ring: bool = False,
                    sinks: int = 0):
    """Write one new K/V row ([B, Hkv, 1, D]) a slot into a dense cache
    (``models.attention.KVCache``: K and V [B, Hkv, rows, D], lengths, and a
    quantized cache's fp32 scales [B, Hkv, rows, 1]) at each slot's
    ``start`` position: ``write_cache``'s T == 1 rules. A rolling cache
    (``ring``) stores position p at row p % rows (with ``sinks``: p itself
    below the sinks, sinks_pad + (p - sinks) % (rows - sinks_pad) above)
    and its lengths count every position; otherwise a write at or past
    capacity is dropped and the length stays at rows. A quantized cache
    stores the row quantized (``quantize_values``: payload and scale).
    Rows are written in place; returns the cache with new lengths."""
    writes = []
    for buf, scales, new in ((cache.k, cache.k_scales, k_new), (cache.v, cache.v_scales, v_new)):
        if scales is None:
            writes.append((buf, new.to(buf.dtype)))
        else:
            payload, row_scales = quantize_values(new, buf.dtype)
            writes += [(buf, payload), (scales, row_scales)]
    rows = cache.k.shape[2]
    batch_idx = torch.arange(k_new.shape[0], device=cache.k.device)
    if ring:
        p = start.long()
        if sinks:
            spad = ceil_to(sinks, 128)
            row = torch.where(p < sinks, p, spad + (p - sinks) % (rows - spad))
        else:
            row = p % rows
        for buf, new in writes:
            bits(buf)[batch_idx, :, row] = bits(new[:, :, 0].to(buf.dtype))
        return cache._replace(lengths=(start + 1).to(torch.int32))
    keep = (start < rows)[:, None, None]
    pos = start.clamp(max=rows - 1)
    for buf, new in writes:
        # Rewrite the old row where the write is dropped: no host sync.
        new, buf = bits(new[:, :, 0].to(buf.dtype)), bits(buf)
        buf[batch_idx, :, pos] = torch.where(keep, new, buf[batch_idx, :, pos])
    return cache._replace(lengths=(start + 1).clamp(max=rows).to(torch.int32))


def rope_plain(q, k, positions, *, theta: float = 10000.0, cache=None, v=None, ring: bool = False, sinks: int = 0):
    """The function F2 computes: ``apply_rope`` of q and k, and with
    ``cache`` the row write of ``write_row_plain`` at ``positions``."""
    q, k = apply_rope(q, positions, theta=theta), apply_rope(k, positions, theta=theta)
    if cache is None:
        return q, k
    return q, k, write_row_plain(cache, k, v, positions.reshape(-1), ring=ring, sinks=sinks)


def _positions_2d(positions: torch.Tensor, batch: int, t: int) -> torch.Tensor:
    """Positions broadcastable to [B, 1, T] as a [B or 1, T or 1] int32 tensor."""
    p = positions
    while p.ndim < 2:
        p = p[None]
    if p.ndim == 3 and p.shape[1] == 1:
        p = p[:, 0]
    if p.ndim != 2 or p.shape[0] not in (1, batch) or p.shape[1] not in (1, t):
        raise ValueError(f"rope: positions {tuple(positions.shape)} do not broadcast to [{batch}, 1, {t}]")
    return _build.as_int32(p)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0, cache=None, v=None,
         ring: bool = False, sinks: int = 0):
    """Rotate q [B, Hq, T, D] and k [B, Hkv, T, D] at ``positions``
    (integers broadcastable to [B, 1, T]), as ``apply_rope`` does each.

    With ``cache`` (a dense ``models.attention.KVCache``, T == 1) and the
    new ``v`` [B, Hkv, 1, D], also write the rotated k and v into each
    slot's row at its position (``write_row_plain``'s rules; ``ring``: the
    cache is rolling, with ``sinks``), quantized into a quantized cache.

    Returns (q, k) rotated, contiguous, and with ``cache`` the cache with
    new lengths (its K / V written in place; the lengths replaced, not
    mutated). On the card one launch (F2).
    """
    if not _on_card("rope", q):
        return rope_plain(q, k, positions, theta=theta, cache=cache, v=v, ring=ring, sinks=sinks)
    batch, hq, t, d = q.shape
    hkv = k.shape[1]
    _same("rope", q, k, *(() if v is None else (v,)))
    if k.shape != (batch, hkv, t, d) or d % 2 or d > 256:
        raise ValueError(f"rope: q {tuple(q.shape)}, k {tuple(k.shape)}; the kernel takes an even head_dim <= 256")
    q, k = _build.unit_last_stride(q), _build.unit_last_stride(k)
    pos = _positions_2d(positions, batch, t)
    p_sb = pos.stride(0) if pos.shape[0] > 1 else 0
    p_st = pos.stride(1) if pos.shape[1] > 1 else 0
    q_out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    k_out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    ptrs = [None] * 5  # v, K / V cache rows, their scales
    cache_strides, rows, payload, new_lengths = [0] * 6, 0, _build.DTYPE_CODES[q.dtype], None
    v_strides = [0, 0, 0]
    if cache is not None:
        if v is None or v.shape != k.shape or t != 1 or pos.shape[0] != batch:
            raise ValueError(f"rope: the cache write takes T == 1, v of k's shape and a position a slot; got q "
                             f"{tuple(q.shape)}, v {None if v is None else tuple(v.shape)}, positions "
                             f"{tuple(positions.shape)}")
        v = _build.unit_last_stride(v)
        v_strides = list(v.stride()[:3])
        kc, vc = cache.k, cache.v
        if kc.shape != vc.shape or kc.shape[0] != batch or kc.shape[1] != hkv or kc.shape[3] != d:
            raise ValueError(f"rope: cache {tuple(kc.shape)} / {tuple(vc.shape)} against k {tuple(k.shape)}")
        if kc.stride() != vc.stride() or kc.stride(-1) != 1:
            raise ValueError("rope: the cache write takes K and V caches of one layout with contiguous rows")
        if cache.k_scales is not None:
            payload = _build.kv_payload_code("rope", d, q, kc, vc, cache.k_scales, cache.v_scales)
            if cache.k_scales.stride() != cache.v_scales.stride():
                raise ValueError("rope: the cache write takes K and V scales of one layout")
            cache_strides[3:] = cache.k_scales.stride()[:3]
        elif kc.dtype != q.dtype or kc.device != q.device:
            raise ValueError(f"rope: a {kc.dtype} cache on {kc.device} for {q.dtype} rows on {q.device}")
        if sinks and (not ring or ceil_to(sinks, 128) >= kc.shape[2]):
            raise ValueError(f"rope: sinks ({sinks}) need a rolling cache of more than {ceil_to(sinks, 128)} rows")
        cache_strides[:3] = kc.stride()[:3]
        rows = kc.shape[2]
        new_lengths = torch.empty((batch,), dtype=torch.int32, device=q.device)
        ptrs = [v.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                None if cache.k_scales is None else cache.k_scales.data_ptr(),
                None if cache.v_scales is None else cache.v_scales.data_ptr()]
    if q_out.numel() or k_out.numel():
        freqs = rope_table(d, float(theta), q.device)
        shape = (batch, t, hq, hkv, d, *q.stride()[:3], *k.stride()[:3], *v_strides, p_sb, p_st, *cache_strides,
                 rows, int(ring), sinks)
        with _build.on_device(q.device):
            err = _build.kernels().fat_rope(
                q.data_ptr(), k.data_ptr(), ptrs[0], q_out.data_ptr(), k_out.data_ptr(), freqs.data_ptr(),
                pos.data_ptr(), *ptrs[1:], None if new_lengths is None else new_lengths.data_ptr(),
                _build.int64_tuple_array(shape), _build.DTYPE_CODES[q.dtype], payload,
                _build.current_stream(q.device))
        _build.check(err, "rope (F2)")
        rope.launches += 1
    if cache is None:
        return q_out, k_out
    return q_out, k_out, cache._replace(lengths=new_lengths)


counter(rope, "launches", "F2", "rope_kernel")
