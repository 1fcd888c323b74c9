"""Paged KV cache: kernels K7, K8 and K9/K10 and their plain versions.

Counterpart of the JAX package's ``ops/paged.py``. KV lives in fixed-size
pages ``[num_pages, kv_heads, page_size, head_dim]``; a slot's
``page_table`` row maps its logical pages to physical ones, and ``lengths``
counts its valid rows.

  * ``paged_decode_attention`` — K7 (csrc/decode.cu, the body K6 uses, read
    through the page table and split over whole pages), replacing
    ``_paged_decode_kernel_hb`` (:980) and ``_paged_decode_kernel``
    (:1104); output and base-2 LSE.
  * ``paged_prefill_attention`` — K8 (csrc/flash_fwd.cu, the FMA body K1
    takes in fp32, read through the page table, in every dtype), replacing ``_paged_prefill_kernel``
    (:580): causal chunk attention over the slot's pages in place.
  * ``paged_write_tokens_multi`` — K9/K10 (csrc/paged_write.cu), replacing
    ``_make_multi_write_kernel`` (:257) and, as its one-layer case through
    ``paged_write_tokens``, ``_write_rows_kernel`` (:130).

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors, with no fallback from one to the other, and counts
kernel launches in ``.launches`` (unquantized pages) and ``.quant_launches``
(quantized pages: K7q, K8q, K9q/K10q). Page ids are clamped into
``[0, num_pages)`` everywhere, as the JAX package's index maps clamp them:
a released slot's table points at dump page 0 while its lane still rides in
the batched decode step.

A model's layers live in one ``PagedModelCache``: one ``[num_layers,
num_pages, ...]`` pool per K and V, one page table and one lengths tensor,
so K10 writes every layer in one launch; each layer's ``PagedKVCache``
holds views of it. Pages and the page table are updated in place;
``lengths`` is replaced, not mutated (as in the dense cache).

Quantized pages (``kv_quant`` int8, fp8_e4m3 or fp8_e5m2) hold an int8 / fp8
payload and one fp32 scale per row and head in scale pools ``[num_layers,
num_pages, kv_heads, page_size]`` (a layer's view ``[num_pages, kv_heads,
page_size]``: the JAX package's ``[num_pages, kv_heads, 1, page_size]`` in
the same memory order, without the size-1 lane axis). K7 and K8 widen and
scale the payload as they read it; K10 quantizes the new rows as it writes
them. Scales are indexed by physical page, so pages shared through the
prefix cache carry theirs.

K7 and K8 take the JAX kernels' masks (K7 :1033, :1065-1066, :1152,
:1188-1189; K8 :642, :680-681): a sliding window and a logit softcap, and
StreamingLLM attention sinks, logical rows [0, sinks) on the pinned logical
page 0, visible beside the window. Their page walks are band-limited (from
max(length - window, 0) // page, plus page 0 with sinks). Over the paged
ring (``serving/paged_engine.py``) a logical page that rolled out of the
window aliases the physical page now holding newer rows; the kernels and
their plain versions mask by logical POSITION, so it is never scored.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import LOG2E, mask_window, sm_count, softcap2
from flash_attention_tpu_torch.ops.decode import (
    check_tma_rows,
    decode_attention_plain,
    decode_blocks,
    decode_kv_splits,
    decode_span_rows,
    scale_strides,
    split_buffers,
)
from flash_attention_tpu_torch.ops.flash_attention import flash_attention_plain
from flash_attention_tpu_torch.ops.quant import bits, payload_dtype, quantize_values

# The kernels read a page in runs of rows that must not straddle it: K8 in
# 64-row kv tiles, K7 in 64-row runs (and splits of whole pages).
KERNEL_PAGE_MULTIPLE = 64


class PagedKVCache(NamedTuple):
    """Paged KV storage of one layer.

    k_pages, v_pages: [num_pages, kv_heads, page_size, head_dim], the
      model's dtype or a quantized payload (int8 / fp8).
    page_table: [num_slots, pages_per_slot] int32 physical page per logical
      page; entries past a slot's last page are unused.
    lengths: [num_slots] int32 valid rows per slot.
    k_scales, v_scales: None, or [num_pages, kv_heads, page_size] fp32, one
      scale per row of a quantized payload.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[1]


class PagedModelCache(NamedTuple):
    """Paged KV storage of every layer of a model: one pool per K and V,
    and one page table and one lengths tensor that all layers share.

    k_pool, v_pool: [num_layers, num_pages, kv_heads, page_size, head_dim].
    page_table, lengths: as in PagedKVCache.
    k_scales, v_scales: None, or [num_layers, num_pages, kv_heads,
      page_size] fp32 for quantized pools.
    """

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    def quantized(self) -> bool:
        return self.k_scales is not None

    def layers(self) -> list[PagedKVCache]:
        """Each layer's PagedKVCache: views of its pages (and scales), and the
        shared table and lengths."""
        n = self.k_pool.shape[0]
        ks = self.k_scales.unbind(0) if self.quantized() else [None] * n
        vs = self.v_scales.unbind(0) if self.quantized() else [None] * n
        return [
            PagedKVCache(k, v, self.page_table, self.lengths, k_s, v_s)
            for k, v, k_s, v_s in zip(self.k_pool.unbind(0), self.v_pool.unbind(0), ks, vs)
        ]


def init_paged_model_cache(
    num_layers: int,
    *,
    num_pages: int,
    num_slots: int,
    pages_per_slot: int,
    kv_heads: int,
    page_size: int = 512,
    head_dim: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    kv_quant: str = "none",
    device: str | torch.device = "cuda",
) -> PagedModelCache:
    """A zeroed PagedModelCache of ``num_layers`` layers on ``device`` (the
    card by default). With ``kv_quant`` (int8, fp8_e4m3 or fp8_e5m2) the
    pools hold that payload, zeroed, and scale pools of ones."""
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"paged pages are float32, float16 or bfloat16, got {dtype}")
    payload = payload_dtype(kv_quant)
    shape = (num_layers, num_pages, kv_heads, page_size, head_dim)
    scales = [None, None]
    if payload is not None:
        scales = [torch.ones(shape[:-1], dtype=torch.float32, device=device) for _ in range(2)]
    return PagedModelCache(
        torch.zeros(shape, dtype=payload or dtype, device=device),
        torch.zeros(shape, dtype=payload or dtype, device=device),
        torch.zeros((num_slots, pages_per_slot), dtype=torch.int32, device=device),
        torch.zeros((num_slots,), dtype=torch.int32, device=device),
        *scales,
    )


def init_paged_cache(**kwargs) -> PagedKVCache:
    """One layer's zeroed cache (``init_paged_model_cache``'s keyword
    arguments)."""
    return init_paged_model_cache(1, **kwargs).layers()[0]


def _clamped(table: torch.Tensor, num_pages: int) -> torch.Tensor:
    return table.long().clamp(0, num_pages - 1)


def _gather_slots(pages: torch.Tensor, table_rows: torch.Tensor, scales: torch.Tensor | None = None) -> torch.Tensor:
    """[S, n] page ids -> the pages as dense [S, kv_heads, n * page_size, D],
    dequantized to fp32 when ``scales`` ([num_pages, kv_heads, page_size])
    are given."""
    ids = _clamped(table_rows, pages.shape[0])
    x = bits(pages)[ids]  # [S, n, H, page, D]
    s, n, h, page, d = x.shape
    x = x.transpose(1, 2).reshape(s, h, n * page, d).view(pages.dtype)
    if scales is None:
        return x
    return x.float() * scales[ids].transpose(1, 2).reshape(s, h, n * page, 1)


def _gather_kv(cache: PagedKVCache, table_rows: torch.Tensor):
    """K and V of the slots in ``table_rows``, gathered densely (and
    dequantized to fp32 for a quantized cache)."""
    return (_gather_slots(cache.k_pages, table_rows, cache.k_scales),
            _gather_slots(cache.v_pages, table_rows, cache.v_scales))


def paged_gather_kv(cache: PagedKVCache, slot: int, kv_end: int, dtype=None):
    """``slot``'s first ``kv_end`` rows (a page multiple) as dense
    [1, kv_heads, kv_end, head_dim] K and V, dequantized (to bf16 unless
    ``dtype`` says otherwise, as in the JAX package) for a quantized cache."""
    if kv_end % cache.page_size:
        raise ValueError(f"kv_end={kv_end} not a multiple of page_size {cache.page_size}")
    rows = cache.page_table[slot : slot + 1, : kv_end // cache.page_size]
    dtype = dtype or (torch.bfloat16 if cache.quantized() else cache.k_pages.dtype)
    k, v = _gather_kv(cache, rows)
    return k.to(dtype), v.to(dtype)


def paged_write_prefill(
    cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor, slot: int, true_len, start: int = 0
) -> PagedKVCache:
    """Write [kv_heads, T, head_dim] K/V rows (T a page multiple) at logical
    positions [start, start + T) of ``slot`` (start a page multiple), in
    place, and set ``lengths[slot] = true_len``. Returns the cache."""
    page = cache.page_size
    heads, t, d = k_new.shape
    if t % page:
        raise ValueError(f"prefill length {t} not a multiple of page_size {page}")
    n = t // page
    phys = _clamped(cache.page_table[slot, start // page : start // page + n], cache.k_pages.shape[0])
    writes = ((cache.k_pages, cache.k_scales, k_new), (cache.v_pages, cache.v_scales, v_new))
    for pages, scales, new in writes:
        if scales is not None:
            # Per row, so quantizing all T rows at once is the JAX package's
            # page-by-page scan (ops/paged.py:512-546) to the bit.
            new, new_scales = quantize_values(new, pages.dtype)
            scales[phys] = new_scales.reshape(heads, n, page).transpose(0, 1)
        bits(pages)[phys] = bits(new.reshape(heads, n, page, d).transpose(0, 1).to(pages.dtype))
    lengths = cache.lengths.clone()
    lengths[slot] = true_len
    return cache._replace(lengths=lengths)


def paged_write_tokens_plain(cache: PagedModelCache, k_new, v_new, slots: torch.Tensor) -> torch.Tensor:
    """The function K9/K10 computes, by index assignment: every layer's row
    for listed slot i goes to its slot's next position, where the slot has
    room for it, quantized per row (``quantize_values``) into a quantized
    cache with its scale beside it; returns that ``valid`` [n] as int32."""
    page = cache.k_pool.shape[3]
    pos = cache.lengths[slots].long()
    valid = pos < cache.page_table.shape[1] * page
    keep = valid.nonzero()[:, 0]
    pos = pos[keep]
    phys = _clamped(cache.page_table[slots[keep], pos // page], cache.k_pool.shape[1])
    for pool, scales, new in ((cache.k_pool, cache.k_scales, k_new), (cache.v_pool, cache.v_scales, v_new)):
        new = new[:, keep].transpose(0, 1)  # [n_keep, L, H, D]
        if scales is not None:
            new, new_scales = quantize_values(new, pool.dtype)
            scales[:, phys, :, pos % page] = new_scales[..., 0]
        bits(pool)[:, phys, :, pos % page] = bits(new.to(pool.dtype))
    return valid.to(torch.int32)


def _write_tokens_kernel(k_pool, v_pool, k_scales, v_scales, table, lengths, k_new, v_new, slots):
    """K9/K10 (K9q/K10q over payload pools with scales): one launch that
    writes every layer's new row for each listed slot and returns the new
    lengths. k_pool, v_pool: a model's [L, num_pages, H, page, D] pools, or
    (K9) one layer's [num_pages, H, page, D] pages; k_new, v_new: [L, n, H,
    D], or [n, H, D] for one layer's pages."""
    lead = k_pool.ndim - 4  # 1 for a model's pools, 0 for a layer's pages
    num_layers = k_pool.shape[0] if lead else 1
    num_pages, heads, page, d = k_pool.shape[lead:]
    want = (*k_pool.shape[:lead], slots.numel(), heads, d)
    quant = k_scales is not None
    if quant:
        payload = _build.kv_payload_code("paged_write_tokens_multi", d, k_new, k_pool, v_pool, k_scales, v_scales)
        k_new, v_new = k_new.contiguous(), v_new.to(k_new.dtype).contiguous()
    else:
        _build.check_operands("paged_write_tokens_multi", d, k_pool, v_pool)
        k_new, v_new = k_new.to(k_pool.dtype).contiguous(), v_new.to(v_pool.dtype).contiguous()
    if k_new.shape != want or v_new.shape != want:
        raise ValueError(f"new rows {tuple(k_new.shape)} / {tuple(v_new.shape)} != {want}")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(-1) != 1:
        raise ValueError("the CUDA page write takes K and V pools of one layout with contiguous rows")
    strides = [k_pool.stride(0) if lead else 0, *k_pool.stride()[lead:lead + 3]]  # layer, page, head, row
    if quant:
        if k_scales.stride() != v_scales.stride() or k_scales.stride(-1) != 1:
            raise ValueError("the CUDA page write takes K and V scale pools of one layout with contiguous rows")
        s_strides = [k_scales.stride(0) if lead else 0, *k_scales.stride()[lead:lead + 2]]
    else:
        item = k_pool.element_size()
        strides = [s * item for s in strides]
        ptrs = [k_new, v_new, k_pool, v_pool]
        if (d * item) % 16 or any(s % 16 for s in strides) or any(t.data_ptr() % 16 for t in ptrs):
            raise ValueError("the CUDA page write copies 16-byte words: rows, strides and pointers must be 16-byte aligned")
    table, lengths32 = _build.as_int32(table), _build.as_int32(lengths)
    if slots.dtype not in (torch.int32, torch.int64):
        slots = slots.long()
    slots = slots.contiguous()
    new_lengths = torch.empty_like(lengths32)
    slot_args = (lengths32.data_ptr(), table.data_ptr(), slots.data_ptr(), int(slots.dtype == torch.int64),
            new_lengths.data_ptr(), num_layers, slots.numel(), lengths32.numel(), heads)
    lib = _build.kernels()
    with _build.on_device(slots.device):
        stream = _build.current_stream(slots.device)
        if quant:
            err = lib.fat_paged_write_quant(
                k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scales.data_ptr(),
                v_scales.data_ptr(), *slot_args, d, num_pages, page, table.shape[1], *strides, *s_strides,
                _build.DTYPE_CODES[k_new.dtype], payload, stream,
            )
        else:
            err = lib.fat_paged_write(
                k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *slot_args, d * item,
                num_pages, page, table.shape[1], *strides, stream,
            )
    _build.check(err, "paged_write_tokens_multi (K9q/K10q)" if quant else "paged_write_tokens_multi (K9/K10)")
    if quant:
        paged_write_tokens_multi.quant_launches += 1
    else:
        paged_write_tokens_multi.launches += 1
    return new_lengths if lengths.dtype == torch.int32 else new_lengths.to(lengths.dtype)


def paged_write_tokens_multi(cache: PagedModelCache, k_new: torch.Tensor, v_new: torch.Tensor, slots) -> PagedModelCache:
    """Append ONE token of K/V per listed slot to EVERY layer's pages.

    k_new, v_new: [num_layers, n, kv_heads, head_dim]; slots: [n] slot ids,
    each at most once. A slot writes only where it has room (position <
    pages_per_slot * page_size): a slot at capacity writes nothing and its
    length stays. A quantized cache stores each row quantized (its payload
    and its scale). Pages are written in place; returns the cache with its
    one lengths tensor advanced by one where the slot wrote. On the card
    this is one launch (K10), which also writes the new lengths; ``slots``
    is read as it is held when int32 or int64.
    """
    device = cache.k_pool.device
    if device.type == "cpu":
        slots = torch.as_tensor(slots, device=device).long()
        valid = paged_write_tokens_plain(cache, k_new, v_new, slots)
        return cache._replace(lengths=cache.lengths.index_add(0, slots, valid.to(cache.lengths.dtype)))
    if device.type != "cuda":
        raise ValueError(f"paged_write_tokens_multi runs on cpu or cuda tensors, got {device}")
    slots = torch.as_tensor(slots, device=device)
    if not slots.numel():
        return cache
    return cache._replace(lengths=_write_tokens_kernel(
        cache.k_pool, cache.v_pool, cache.k_scales, cache.v_scales, cache.page_table, cache.lengths, k_new, v_new,
        slots))


paged_write_tokens_multi.launches = 0
paged_write_tokens_multi.quant_launches = 0


def paged_write_tokens(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor, slots) -> PagedKVCache:
    """Append ONE token of K/V ([n, kv_heads, head_dim]) per listed slot at
    its current length: ``paged_write_tokens_multi``'s function with one
    layer. On the card, the same one launch (K9) over this layer's pages."""
    device = cache.k_pages.device
    if device.type == "cuda":
        slots = torch.as_tensor(slots, device=device)
        if not slots.numel():
            return cache
        return cache._replace(lengths=_write_tokens_kernel(
            cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales, cache.page_table, cache.lengths, k_new,
            v_new, slots))
    scales = [None, None] if not cache.quantized() else [cache.k_scales[None], cache.v_scales[None]]
    one = PagedModelCache(cache.k_pages[None], cache.v_pages[None], cache.page_table, cache.lengths, *scales)
    return cache._replace(lengths=paged_write_tokens_multi(one, k_new[None], v_new[None], slots).lengths)


def _check_kernel_pages(what: str, cache: PagedKVCache, q: torch.Tensor) -> int:
    """Raise on pages the CUDA kernels do not take; return the payload code."""
    payload = _build.kv_payload_code(what, q.shape[-1], q, cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales)
    if cache.quantized() and not cache.k_scales.shape == cache.v_scales.shape == cache.k_pages.shape[:3]:
        raise ValueError(f"{what}: scales {tuple(cache.k_scales.shape)} / {tuple(cache.v_scales.shape)} "
                         f"!= pages' {tuple(cache.k_pages.shape[:3])}")
    if cache.page_size % KERNEL_PAGE_MULTIPLE:
        raise ValueError(f"{what}: the CUDA kernel takes page_size a multiple of {KERNEL_PAGE_MULTIPLE}, got {cache.page_size}")
    if cache.page_table.dtype != torch.int32 or not cache.page_table.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes a contiguous int32 page table")
    return payload


def _scale_ptrs(cache: PagedKVCache) -> list:
    if not cache.quantized():
        return [None, None]
    return [cache.k_scales.data_ptr(), cache.v_scales.data_ptr()]


def _check_masks(cache: PagedKVCache, sliding_window, logit_softcap, attention_sinks) -> None:
    """The JAX wrappers' mask checks (ops/paged.py:962-970, :1265-1274)."""
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if attention_sinks:
        if sliding_window is None:
            raise ValueError("attention_sinks requires sliding_window")
        if attention_sinks >= cache.page_size:
            raise ValueError(f"attention_sinks ({attention_sinks}) must fit the pinned first page ({cache.page_size} rows)")


def paged_decode_attention_plain(
    q: torch.Tensor, cache: PagedKVCache, *, sm_scale: float, save_residuals: bool = False,
    sliding_window: int | None = None, logit_softcap: float | None = None, attention_sinks: int = 0,
):
    """The function K7 computes: the slots' pages gathered densely in
    logical order (and dequantized to fp32), then the decode math of
    ``decode_attention_plain`` over logical positions."""
    k, v = _gather_kv(cache, cache.page_table)
    return decode_attention_plain(
        q, k, v, cache.lengths, sm_scale=sm_scale, save_residuals=save_residuals,
        sliding_window=sliding_window, logit_softcap=logit_softcap, attention_sinks=attention_sinks,
    )


def paged_decode_attention(
    q: torch.Tensor, cache: PagedKVCache, *, sm_scale: float | None = None, save_residuals: bool = False,
    sliding_window: int | None = None, logit_softcap: float | None = None, attention_sinks: int = 0,
):
    """Single-token decode over the paged cache.

    Args:
      q: [num_slots, q_heads, head_dim] current-token queries of every slot;
        q_heads % kv_heads == 0. Slot b attends its rows [0, lengths[b]).
      save_residuals: also return the base-2 LSE [num_slots, q_heads] fp32
        (-inf for a slot of length 0, whose output is 0).
      sliding_window: attend only logical rows >= lengths - window.
      logit_softcap: scores become cap * tanh(score / cap).
      attention_sinks: logical rows [0, sinks) stay visible beside the
        window (requires the window; sinks < page_size).

    Returns:
      [num_slots, q_heads, head_dim] in q's dtype, plus the LSE if asked.
    """
    if q.ndim != 3:
        raise ValueError("expected q [num_slots, q_heads, head_dim]")
    num_slots, num_q_heads, head_dim = q.shape
    num_pages, num_kv_heads, page, d = cache.k_pages.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if d != head_dim or cache.v_pages.shape != cache.k_pages.shape:
        raise ValueError(f"q {tuple(q.shape)} / pages {tuple(cache.k_pages.shape)}, {tuple(cache.v_pages.shape)} mismatch")
    if cache.page_table.shape[0] != num_slots or cache.lengths.shape != (num_slots,):
        raise ValueError(f"{num_slots} query slots against a table of {tuple(cache.page_table.shape)}")
    _check_masks(cache, sliding_window, logit_softcap, attention_sinks)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, cache, sm_scale=sm_scale, save_residuals=save_residuals, sliding_window=sliding_window,
            logit_softcap=logit_softcap, attention_sinks=attention_sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda tensors, got {q.device}")

    payload = _check_kernel_pages("paged_decode_attention", cache, q)
    q = _build.unit_last_stride(q)
    k_pages, v_pages = (_build.unit_last_stride(x) for x in (cache.k_pages, cache.v_pages))
    check_tma_rows("paged_decode_attention", k_pages, v_pages)
    lengths = _build.as_int32(cache.lengths)
    out = torch.empty((num_slots, num_q_heads, head_dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((num_slots, num_q_heads), dtype=torch.float32, device=q.device) if save_residuals else None
    if out.numel():
        group = num_q_heads // num_kv_heads
        span = decode_span_rows(cache.pages_per_slot * page, sliding_window=sliding_window, page_size=page,
                                attention_sinks=attention_sinks)
        splits = decode_kv_splits(num_slots, num_kv_heads, group, span, sm_count(q.device))
        ws, ws_ptr, tickets = split_buffers(q.device, num_slots, num_q_heads, num_kv_heads, head_dim, splits)
        lib = _build.kernels()
        with _build.on_device(q.device):
            err = lib.fat_paged_decode(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *_scale_ptrs(cache), out.data_ptr(),
                None if lse is None else lse.data_ptr(), lengths.data_ptr(), cache.page_table.data_ptr(), ws_ptr,
                tickets,
                _build.int64_tuple_array((
                    num_slots, num_q_heads, num_kv_heads, cache.pages_per_slot * page, head_dim, q.stride(0),
                    q.stride(1), mask_window(sliding_window), 0, attention_sinks, splits,
                    _build.DTYPE_CODES[q.dtype], payload, *k_pages.stride()[:3], *v_pages.stride()[:3],
                    *scale_strides(cache.k_scales, cache.v_scales), num_pages, page, cache.pages_per_slot,
                )),
                sm_scale * LOG2E, softcap2(logit_softcap), _build.current_stream(q.device),
            )
        _build.check(err, "paged_decode_attention (K7)")
        paged_decode_attention.last_grid = (splits, decode_blocks(num_slots, num_kv_heads, group, splits))
        if cache.quantized():
            paged_decode_attention.quant_launches += 1
        else:
            paged_decode_attention.launches += 1
    return (out, lse) if save_residuals else out


paged_decode_attention.launches = 0
paged_decode_attention.quant_launches = 0
paged_decode_attention.last_grid = None  # (splits, blocks) of the last launch


def paged_prefill_attention_plain(
    q: torch.Tensor, cache: PagedKVCache, slot: int, kv_end: int, *, sm_scale: float,
    sliding_window: int | None = None, logit_softcap: float | None = None, attention_sinks: int = 0,
):
    """The function K8 computes: the slot's first kv_end logical rows
    gathered densely (and dequantized to fp32), then causal
    ``flash_attention_plain``, end-aligned, with the masks."""
    n = -(-kv_end // cache.page_size)
    k, v = _gather_kv(cache, cache.page_table[slot : slot + 1, :n])
    return flash_attention_plain(
        q, k[:, :, :kv_end], v[:, :, :kv_end], causal=True, sm_scale=sm_scale, save_residuals=False,
        sliding_window=sliding_window, logit_softcap=logit_softcap, sinks=attention_sinks,
    )


def paged_prefill_attention(
    q: torch.Tensor, cache: PagedKVCache, slot: int, kv_end: int, *, chunk_len: int, sm_scale: float | None = None,
    sliding_window: int | None = None, logit_softcap: float | None = None, attention_sinks: int = 0,
) -> torch.Tensor:
    """Causal chunk attention over ``slot``'s pages, read in place.

    Args:
      q: [1, q_heads, chunk_len, head_dim], the chunk whose rows sit at
        positions [kv_end - chunk_len, kv_end); its own K/V must already be
        written to the slot's pages.
      slot, kv_end: host integers; kv_end is the exclusive end of the
        visible rows, at least chunk_len and at most the slot's capacity.
      chunk_len: any length (the JAX package's Pallas grid needs a
        multiple of 128; K8 tiles q in 64-row blocks bounded by T).
      sliding_window, logit_softcap, attention_sinks: as in
        ``paged_decode_attention``; the window is end-aligned per row.

    Returns:
      [1, q_heads, chunk_len, head_dim] in q's dtype.
    """
    _, num_q_heads, t, head_dim = q.shape
    num_pages, num_kv_heads, page, _ = cache.k_pages.shape
    if t != chunk_len:
        raise ValueError(f"q chunk length {t} != chunk_len {chunk_len}")
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    kv_end = int(kv_end)
    if kv_end < chunk_len:
        raise ValueError(
            f"kv_end={kv_end} < chunk_len={chunk_len}: the chunk's rows occupy "
            "[kv_end - chunk_len, kv_end), which must not be negative"
        )
    if kv_end > cache.pages_per_slot * page:
        raise ValueError(f"kv_end={kv_end} exceeds slot capacity {cache.pages_per_slot} pages x {page} rows")
    _check_masks(cache, sliding_window, logit_softcap, attention_sinks)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, cache, slot, kv_end, sm_scale=sm_scale, sliding_window=sliding_window,
            logit_softcap=logit_softcap, attention_sinks=attention_sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cpu or cuda tensors, got {q.device}")

    payload = _check_kernel_pages("paged_prefill_attention", cache, q)
    q = _build.unit_last_stride(q)
    k_pages, v_pages = (_build.unit_last_stride(x) for x in (cache.k_pages, cache.v_pages))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        lib = _build.kernels()
        with torch.cuda.device(q.device):
            err = lib.fat_paged_prefill(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *_scale_ptrs(cache), out.data_ptr(),
                cache.page_table[slot].data_ptr(), num_q_heads, num_kv_heads, num_pages, page, t,
                kv_end, head_dim, q.stride(1), q.stride(2), *k_pages.stride()[:3], *v_pages.stride()[:3],
                _build.int64_array(scale_strides(cache.k_scales, cache.v_scales)),
                sm_scale * LOG2E, mask_window(sliding_window), attention_sinks, softcap2(logit_softcap),
                _build.DTYPE_CODES[q.dtype], payload,
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(err, "paged_prefill_attention (K8)")
        if cache.quantized():
            paged_prefill_attention.quant_launches += 1
        else:
            paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.quant_launches = 0
