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
  * ``rope_chunk`` (F2c, F2's chunk form) — a prefill chunk's RoPE and its
    cache write in one launch a layer: q and k rotated at start + t, the
    rotated k and the new v written into the slot's rows of a dense cache,
    a rolling ring (with sinks) or a page pool, quantized or not, and the
    slot's new length (JAX ``models/attention.py:363-433`` and
    ``ops/paged.py:488-546``, which XLA fuses inside the jitted chunk
    step); its plain versions ``write_chunk_plain`` and
    ``write_pages_plain`` are the eager writes the chunk paths issued;
  * ``swiglu_act`` (F3) — silu(gate) * up (JAX ``models/transformer.py:103``).

The paged decode's self term (JAX ``attention_decode_paged_deferred``) is
K7's (``ops/paged.paged_decode_attention(self_kv=...)``).

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors, with no fallback from one to the other, and counts
its launches (``.launches``, registered in ``ops/counters.py`` as F1, F2,
F2c, F3). A wrapper allocates its outputs with ``torch.empty`` and synchronises
nothing, so each runs inside the decode programs' CUDA graphs. What bounds
the kernels and their design: csrc/fused.cu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.models.rope import apply_rope, rope_table
from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import (
    ceil_to,
    ring_layout,
    ring_rows,
    slot_index,
    slot_rows,
    tma_aligned,
    tma_operands,
)
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


# ---- F2, the chunk form ----

def write_chunk_plain(cache, k_new: torch.Tensor, v_new: torch.Tensor, slot: torch.Tensor, start: int, *,
                      ring: bool = False, sinks: int = 0):
    """Write a prefill chunk's K/V rows ([1, Hkv, T, D]) at positions
    [start, start + T) of ``slot`` (a [1] device int32) of a dense cache
    (``models.attention.KVCache``), quantized into a quantized one
    (``quantize_values``: payload and scale): rows [start, start + T), or
    on a rolling cache (``ring``, with ``sinks``) the rows ``ring_rows``
    gives, which may wrap the ring's end. Rows are written in place, the
    slot's length set to start + T in fresh lengths. Returns the cache."""
    t = k_new.shape[2]
    writes = []
    for buf, scales, new in ((cache.k, cache.k_scales, k_new[0]), (cache.v, cache.v_scales, v_new[0])):
        if scales is None:
            writes.append((buf, new.to(buf.dtype)))
        else:
            payload, row_scales = quantize_values(new, buf.dtype)
            writes += [(buf, payload), (scales, row_scales)]
    if ring:
        at = ring_rows(start + torch.arange(t, device=k_new.device), cache.k.shape[2], sinks)
        for buf, new in writes:
            bits(buf)[slot_rows(buf, slot, at)] = bits(new.to(buf.dtype))[None]
    else:
        for buf, new in writes:
            bits(buf)[slot, :, start:start + t] = bits(new.to(buf.dtype))[None]
    # index_fill_ takes the length as a scalar argument: ``lengths[slot] =
    # start + t`` would copy it from the host, which a capture refuses.
    return cache._replace(lengths=cache.lengths.clone().index_fill_(0, slot.long(), start + t))


def write_pages_plain(cache, k_new: torch.Tensor, v_new: torch.Tensor, slot, true_len, start: int = 0):
    """``ops.paged.paged_write_prefill``: [kv_heads, T, head_dim] K/V rows
    (T a page multiple) at logical positions [start, start + T) of
    ``slot``'s pages (start a page multiple; each physical page id clamped
    into the pool), quantized into a quantized pool, in place, and
    ``lengths[slot] = true_len``. Returns the cache."""
    page = cache.page_size
    heads, t, d = k_new.shape
    if t % page:
        raise ValueError(f"prefill length {t} not a multiple of page_size {page}")
    n = t // page
    slot = slot_index(slot, cache.page_table.shape[0], cache.page_table.device)
    table = cache.page_table[slot, start // page : start // page + n][0]
    phys = table.long().clamp(0, cache.k_pages.shape[0] - 1)
    writes = ((cache.k_pages, cache.k_scales, k_new), (cache.v_pages, cache.v_scales, v_new))
    for pages, scales, new in writes:
        if scales is not None:
            # Per row, so quantizing all T rows at once is the JAX package's
            # page-by-page scan (ops/paged.py:512-546) to the bit.
            new, new_scales = quantize_values(new, pages.dtype)
            scales[phys] = new_scales.reshape(heads, n, page).transpose(0, 1)
        bits(pages)[phys] = bits(new.reshape(heads, n, page, d).transpose(0, 1).to(pages.dtype))
    # index_fill_ takes the length as a scalar argument (an index assignment
    # would copy it from the host, which a CUDA-graph capture refuses).
    return cache._replace(lengths=cache.lengths.clone().index_fill_(0, slot.long(), true_len))


def _paged(cache) -> bool:
    """A page cache (``ops.paged.PagedKVCache``), not a dense one."""
    return hasattr(cache, "page_table")


def rope_chunk_plain(q, k, v, cache, slot, start: int, *, theta: float = 10000.0, ring: bool = False,
                     sinks: int = 0):
    """The function F2c computes: ``apply_rope`` of q and k at positions
    start + t, then ``write_pages_plain`` (a page cache) or
    ``write_chunk_plain`` (a dense one) of the rotated k and v."""
    t = q.shape[2]
    positions = start + torch.arange(t, device=q.device)[None, None, :]
    q, k = apply_rope(q, positions, theta=theta), apply_rope(k, positions, theta=theta)
    if _paged(cache):
        return q, write_pages_plain(cache, k[0], v[0], slot, start + t, start)
    return q, write_chunk_plain(cache, k, v, slot, start, ring=ring, sinks=sinks)


def rope_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache, slot, start: int, *,
               theta: float = 10000.0, ring: bool = False, sinks: int = 0):
    """A prefill chunk's RoPE and cache write: q [1, Hq, T, D] and k [1,
    Hkv, T, D] rotated at positions start + t (``apply_rope``), the rotated
    k and the new v [1, Hkv, T, D] written into ``slot``'s rows [start,
    start + T), and the slot's length set to start + T.

    ``cache``: a dense ``models.attention.KVCache`` (``ring``: a rolling
    one, with ``sinks``; a chunk may wrap the ring's end, whose modulus must
    hold the chunk's rows apart), or an ``ops.paged.PagedKVCache`` (start
    and T page multiples: logical page start / page + j of the slot's table
    row, the physical id clamped into the pool); quantized or not.
    ``slot``: a host int or a one-element device tensor, read on the device.
    ``start``: a host int.

    Returns (q rotated, contiguous, and the cache with new lengths: its K /
    V (and scales) written in place, the lengths replaced, not mutated). On
    the card one launch (F2c) for bf16 / fp16 / fp32 rows at head_dim 32,
    64 or 128."""
    paged = _paged(cache)
    kc, vc = (cache.k_pages, cache.v_pages) if paged else (cache.k, cache.v)
    slot = slot_index(slot, (cache.page_table if paged else kc).shape[0], q.device)
    batch, hq, t, d = q.shape
    hkv, rows = k.shape[1], kc.shape[2]
    if batch != 1 or k.shape != (1, hkv, t, d) or v.shape != k.shape or start < 0:
        raise ValueError(f"rope_chunk: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, start {start}; "
                         "want one sequence's chunk from start >= 0")
    if kc.shape != vc.shape or kc.shape[1] != hkv or kc.shape[3] != d:
        raise ValueError(f"rope_chunk: cache {tuple(kc.shape)} / {tuple(vc.shape)} against k {tuple(k.shape)}")
    if paged:
        if ring or sinks or start % rows or t % rows or (start + t) // rows > cache.page_table.shape[1]:
            raise ValueError(f"rope_chunk: a page cache takes no ring, and rows [{start}, {start + t}) of whole "
                             f"{rows}-row pages within the slot's {cache.page_table.shape[1]}")
    elif ring:
        ring_mod, ring_base = ring_layout(rows, sinks)
        if ring_base >= rows or ring_mod < t:
            raise ValueError(f"rope_chunk: a ring of {rows} rows with {sinks} sinks holds no {t} rows apart")
    elif sinks or start + t > rows:
        raise ValueError(f"rope_chunk: rows [{start}, {start + t}) of a dense cache of {rows}, {sinks} sinks without "
                         "a ring")
    if not _on_card("rope_chunk", q):
        return rope_chunk_plain(q, k, v, cache, slot, start, theta=theta, ring=ring, sinks=sinks)
    _same("rope_chunk", q, k, v)
    if d not in _build.HEAD_DIMS:
        raise ValueError(f"rope_chunk: the kernel takes head_dim in {_build.HEAD_DIMS}, got {d}")
    if kc.stride() != vc.stride() or not all(tma_aligned(x) for x in (kc, vc)):
        raise ValueError("rope_chunk: the kernel stores 16-byte pieces of rows: K and V caches of one layout, rows "
                         "contiguous and 16-byte aligned")
    scale_strides = [0, 0, 0]
    if cache.k_scales is not None:
        payload = _build.kv_payload_code("rope_chunk", d, q, kc, vc, cache.k_scales, cache.v_scales)
        if cache.k_scales.stride() != cache.v_scales.stride():
            raise ValueError("rope_chunk: the cache write takes K and V scales of one layout")
        scale_strides = list(cache.k_scales.stride()[:3])
    elif kc.dtype != q.dtype or kc.device != q.device:
        raise ValueError(f"rope_chunk: a {kc.dtype} cache on {kc.device} for {q.dtype} rows on {q.device}")
    else:
        payload = _build.DTYPE_CODES[q.dtype]
    table, table_stride, num_pages = None, 0, 0
    if paged:
        table, num_pages = _build.as_int32(cache.page_table), kc.shape[0]
        table_stride = table.stride(0)
    q, k, v = tma_operands(q, k, v)  # 16-byte rows: each copied only if it is not
    lengths = _build.as_int32(cache.lengths)
    q_out = torch.empty((1, hq, t, d), dtype=q.dtype, device=q.device)
    new_lengths = torch.empty_like(lengths)
    freqs = rope_table(d, float(theta), q.device)
    shape = (t, hq, hkv, d, *q.stride()[1:3], *k.stride()[1:3], *v.stride()[1:3], *kc.stride()[:3], *scale_strides,
             rows, int(ring), sinks, start, start + t, lengths.shape[0], table_stride, num_pages)
    with _build.on_device(q.device):
        err = _build.kernels().fat_rope_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_out.data_ptr(), freqs.data_ptr(), slot.data_ptr(),
            lengths.data_ptr(), new_lengths.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            None if cache.k_scales is None else cache.k_scales.data_ptr(),
            None if cache.v_scales is None else cache.v_scales.data_ptr(), None if table is None else table.data_ptr(),
            _build.int64_tuple_array(shape), _build.DTYPE_CODES[q.dtype], payload, _build.current_stream(q.device))
    _build.check(err, "rope_chunk (F2c)")
    rope_chunk.launches += 1
    return q_out, cache._replace(lengths=new_lengths)


counter(rope_chunk, "launches", "F2c", "rope_chunk_kernel")
