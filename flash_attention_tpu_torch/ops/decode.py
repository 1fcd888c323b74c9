"""Single-token decode attention: kernel K6 (csrc/decode.cu) and its plain version.

Replaces the JAX package's ``ops/decode.py:_decode_kernel``, reached from
``decode_attention`` (:299), on bf16, fp16 and fp32 caches and on quantized
ones (``ops/quant.QuantizedTensor``: an int8 / fp8 payload with an fp32
scale per row, which the kernel widens and scales as it loads each row; the
quantized instantiations are called K6q below). What bounds the kernel on an
H100 (the bytes of the cache read) and what its design does about it is
written at the top of csrc/decode.cu.

``decode_attention`` runs the plain PyTorch version for CPU tensors and the
CUDA kernel for CUDA tensors; there is no fallback from one to the other.
``decode_attention.launches`` counts K6 launches over an unquantized cache,
``decode_attention.quant_launches`` those over a quantized one (K6q).

``save_residuals`` also returns the base-2 LSE, which the kernel body shares
with the paged decode K7 (ops/paged.py). The masks are the JAX kernel's
(:91-200): a sliding window, a logit softcap, a rolling ring-buffer cache
(``ring_buffer``: position p at row p % rows, ``lengths`` counting every
position written) and StreamingLLM attention sinks in front of the ring;
the kernel masks by each row's reconstructed POSITION and walks only the
live rows. The kernel splits each sequence's live rows over several blocks
(flash-decoding) when batch x kv heads blocks would leave the card idle:
``decode_kv_splits`` chooses the count from the shapes alone, and the kernel
merges the splits itself, in a fixed order, in the same launch.

The JAX package's public split API is here too: ``decode_attention_split``
(num_splits), ``should_split_decode`` and ``decode_attention(auto_split=...)``.
Where JAX copies the cache into [B * splits, ...] pieces and merges them
after the kernel, the port hands the count to K6's own split, so no cache
byte is copied; on the CPU the plain path cuts the rows as the kernel does
(``decode_split_runs``) and merges the parts with
``ops.merge.merge_partial_attention``.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import (
    LOG2E,
    M_FLOOR,
    MASK_VALUE,
    TMA_ALIGN,
    ceil_to,
    mask_window,
    sm_count,
    softcap2,
    tma_aligned,
)
from flash_attention_tpu_torch.ops.counters import counter
from flash_attention_tpu_torch.ops.merge import merge_partial_attention
from flash_attention_tpu_torch.ops.quant import QuantizedTensor, dequantize


def split_quant(x):
    """(payload, scales) of a QuantizedTensor; (x, None) of a plain tensor."""
    if isinstance(x, QuantizedTensor):
        return x.values, x.scales
    return x, None


def scale_strides(k_scales, v_scales) -> list[int]:
    """The first three strides of K's and V's scales (the dims a cache row
    is indexed by), or zeros for an unquantized cache."""
    if k_scales is None:
        return [0] * 6
    return [*k_scales.stride()[:3], *v_scales.stride()[:3]]


def visible_rows(lengths: torch.Tensor, rows: int, *, sliding_window=None, ring_buffer=False, attention_sinks=0):
    """[B, rows] bool: which cache rows each sequence attends, by the
    position each row holds (the JAX kernel's masks, ops/decode.py:166-199,
    and the paged kernels' sinks):

      * not a ring: row r holds position r, visible when r < L and (no
        window, or r >= L - window, or r < sinks: logical page 0's sinks);
      * a ring: row r holds L - 1 - ((L - 1 - r) mod rows), visible when
        that is >= max(0, L - window);
      * a ring with sinks: rows [0, sinks_pad) hold positions [0, sinks)
        (visible when r < sinks and r < L) and the rest is a ring of modulus
        rows - sinks_pad over positions >= sinks, visible when the position
        is >= max(sinks, L - window).
    """
    col = torch.arange(rows, device=lengths.device)[None, :]
    L = lengths.long()[:, None]
    if not ring_buffer:
        ok = col < L
        if sliding_window is not None:
            ok = ok & ((col >= L - sliding_window) | (col < attention_sinks))
        return ok
    if not attention_sinks:
        pos = L - 1 - torch.remainder(L - 1 - col, rows)
        return pos >= (L - sliding_window).clamp(min=0)
    spad = ceil_to(attention_sinks, 128)
    pos = L - 1 - torch.remainder(L - 1 - attention_sinks - (col - spad), rows - spad)
    ring_ok = pos >= (L - sliding_window).clamp(min=attention_sinks)
    return torch.where(col < spad, (col < attention_sinks) & (col < L), ring_ok)


# csrc/decode.cu's shapes: a stage holds DECODE_RUN rows (16 for each of its
# four warps), the unit a split is cut in (K7: whole pages); a block
# serves up to DECODE_GROUP query rows of one GQA group (the mma's M).
DECODE_RUN = 64
DECODE_GROUP = 16
MIN_SPLIT_ROWS = 256


def decode_kv_splits(batch: int, num_kv_heads: int, group: int, span_rows: int, num_sms: int) -> int:
    """How many blocks share each sequence's rows in K6 / K7: enough that
    the batch x kv heads x query chunks blocks make at least two an SM, but
    no split under about MIN_SPLIT_ROWS rows and never more splits than the
    span has runs. ``span_rows`` is the most rows a sequence can walk
    (``decode_span_rows``); the shapes alone decide, so the host never reads
    ``lengths`` (a sync would stall the decode loop and break a CUDA graph)."""
    blocks = decode_blocks(batch, num_kv_heads, group, 1)
    want = -(-2 * num_sms // max(blocks, 1))
    runs = -(-span_rows // DECODE_RUN)
    return max(1, min(want, span_rows // MIN_SPLIT_ROWS, runs))


def decode_blocks(batch: int, num_kv_heads: int, group: int, splits: int) -> int:
    """The kernel's grid: one block per (kv head, batch row, chunk of up to
    DECODE_GROUP query rows, split)."""
    return batch * num_kv_heads * -(-group // DECODE_GROUP) * splits


def decode_span_rows(rows: int, *, sliding_window=None, ring_buffer=False, page_size=None, attention_sinks=0) -> int:
    """The most cache rows one sequence's decode walks: all ``rows`` (max_seq,
    a ring's rows, or K7's pages_per_slot x page_size), or, under a window
    without a ring, the window and the unit it may start inside (K7: a page,
    and the sinks' page)."""
    if sliding_window is None or ring_buffer:
        return rows
    unit = page_size or DECODE_RUN
    return min(rows, sliding_window + unit + (unit if attention_sinks else 0))


def decode_split_runs(length: int, splits: int, *, rows: int, unit: int = DECODE_RUN, sliding_window=None,
                      ring_buffer=False, attention_sinks=0) -> list[list[tuple[int, int]]]:
    """Plain mirror of csrc/decode.cu's cut of one sequence's live rows
    (``make_walk`` and ``Runs``), for the tests: each split's runs as
    (first row, live rows) pairs. The live rows are whole units of ``unit``
    rows (DECODE_RUN, or K7's page): [0, a_end) holding K7's sinks or a ring's
    sink region, then the window's or ring's range; split s walks units
    [s * per, (s + 1) * per) of them, per = ceil(units / splits)."""
    length = max(length, 0)
    a_end, b_start, b_end = 0, 0, min(length, rows)
    if ring_buffer and attention_sinks:
        spad = ceil_to(attention_sinks, 128)
        a_end, b_start = min(attention_sinks, length), spad
        b_end = spad + min(max(length - attention_sinks, 0), rows - spad)
    elif sliding_window is not None and not ring_buffer:
        b_start = max(length - sliding_window, 0) // unit * unit
        a_end = min(attention_sinks, b_start)
    n_a, b_unit0 = -(-a_end // unit), b_start // unit
    n = n_a + max(-(-b_end // unit) - b_unit0, 0)
    per = -(-n // splits)
    out = []
    for s in range(splits):
        u0 = min(s * per, n)
        runs = []
        for u in range(u0, min(u0 + per, n)):
            start = (u if u < n_a else b_unit0 + u - n_a) * unit
            stop = min(start + unit, a_end if u < n_a else b_end)
            runs += [(r0, min(DECODE_RUN, stop - r0)) for r0 in range(start, stop, DECODE_RUN)]
        out.append(runs)
    return out


def check_tma_rows(what: str, *caches: torch.Tensor) -> None:
    """Raise unless TMA can read each [batch or page, heads, rows, D] cache
    as it lies (``tma_aligned``): the kernel copies its rows with TMA."""
    for t in caches:
        if not tma_aligned(t):
            raise ValueError(
                f"{what}: the CUDA kernel reads cache rows with TMA, so the cache's base pointer and its batch "
                f"(page), head and row strides must be multiples of {TMA_ALIGN} bytes; got pointer "
                f"{t.data_ptr() % TMA_ALIGN} bytes past alignment and strides {tuple(t.stride())} of "
                f"{t.element_size()}-byte elements"
            )


_TICKETS: dict = {}
# Ticket buffers that a larger one replaced: a CUDA graph captured over a
# launch keeps its buffer's address for as long as the graph lives (a
# serving engine's decode programs: the engine's life), so no buffer is
# ever freed.
_RETIRED_TICKETS: list = []


def split_buffers(device: torch.device, batch: int, num_q_heads: int, num_kv_heads: int, head_dim: int,
                  splits: int):
    """(workspace, its pointer, the ticket counters' pointer) for a launch
    of ``splits`` splits, or three Nones with one split. The workspace holds
    each split's fp32 m, l and unnormalised O; the caller keeps it alive over
    the launch. The counters are a zeroed int32 buffer kept per device, which
    every launch leaves zero again, so a CUDA graph of the call replays."""
    if splits == 1:
        return None, None, None
    n = decode_blocks(batch, num_kv_heads, num_q_heads // num_kv_heads, 1)
    tickets = _TICKETS.get(device)
    if tickets is None or tickets.numel() < n:
        if tickets is not None:
            _RETIRED_TICKETS.append(tickets)
        tickets = _TICKETS[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    ws = torch.empty(batch * splits * num_q_heads * (head_dim + 2), dtype=torch.float32, device=device)
    return ws, ws.data_ptr(), tickets.data_ptr()


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float,
    save_residuals: bool = False,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    ring_buffer: bool = False,
    attention_sinks: int = 0,
):
    """The function K6 computes, in plain fp32 PyTorch: each row of q
    attends to the rows of its kv head's cache that ``visible_rows`` admits
    (rows [0, lengths[b]) without masks); output 0 (and base-2 LSE -inf)
    where it sees none. The softcap maps the score to cap * tanh(qk *
    sm_scale / cap) before the mask. A quantized cache is dequantized to
    fp32 first."""
    live = visible_rows(lengths.to(q.device), k_cache.shape[2], sliding_window=sliding_window,
                        ring_buffer=ring_buffer, attention_sinks=attention_sinks)
    out, lse = _attend_rows(q, k_cache, v_cache, live, sm_scale, logit_softcap)
    out = out.to(q.dtype)
    return (out, lse) if save_residuals else out


def _attend_rows(q, k_cache, v_cache, live, sm_scale: float, logit_softcap=None):
    """fp32 (output, base-2 LSE) of q [B, Hq, D] over the cache rows that
    ``live`` [B, rows] admits; 0 and -inf where it admits none."""
    if isinstance(k_cache, QuantizedTensor):
        k_cache, v_cache = dequantize(k_cache), dequantize(v_cache)
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads = k_cache.shape[1]
    qg = q.float().reshape(batch, num_kv_heads, num_q_heads // num_kv_heads, head_dim)
    if logit_softcap is None:
        s2 = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * (sm_scale * LOG2E)
    else:
        s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * sm_scale
        s2 = logit_softcap * torch.tanh(s / logit_softcap) * LOG2E
    s2 = torch.where(live[:, None, None, :], s2, MASK_VALUE)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    out = torch.where(l == 0, 0.0, acc / l).reshape(batch, num_q_heads, head_dim)
    lse = torch.where(l == 0, -torch.inf, m + torch.log2(l))
    return out, lse.reshape(batch, num_q_heads)


def decode_split_plain(q, k_cache, v_cache, lengths, splits: int, *, sm_scale: float) -> torch.Tensor:
    """What K6 computes with ``splits`` splits, in plain fp32 PyTorch: each
    split attends over the rows it walks (``decode_split_runs``, the
    kernel's cut) below its sequence's length, and the parts merge with
    ``merge_partial_attention``. Equals ``decode_attention_plain`` up to the
    order of the sums."""
    rows = k_cache.shape[2]
    visible = visible_rows(lengths.to(q.device), rows)
    walked = torch.zeros((splits, *visible.shape), dtype=torch.bool, device=q.device)
    for b, length in enumerate(lengths.tolist()):
        for s, runs in enumerate(decode_split_runs(length, splits, rows=rows)):
            for r0, count in runs:
                walked[s, b, r0:r0 + count] = True
    parts = [_attend_rows(q, k_cache, v_cache, visible & walked[s], sm_scale) for s in range(splits)]
    out, _ = merge_partial_attention(torch.stack([o for o, _ in parts]), torch.stack([x for _, x in parts]))
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
    save_residuals: bool = False,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    ring_buffer: bool = False,
    attention_sinks: int = 0,
    auto_split: bool = False,
):
    """Single-token decode attention over a dense KV cache.

    Args:
      q: [batch, q_heads, head_dim] current-token queries.
      k_cache, v_cache: [batch, kv_heads, max_seq, head_dim] (any batch, head
        and row strides); q_heads % kv_heads == 0. Either plain tensors of
        q's dtype or QuantizedTensors (int8 / fp8 payload with fp32 scales
        [batch, kv_heads, max_seq, 1]), dequantized inside the kernel.
      lengths: [batch] integer — valid KV prefix per sequence (the new
        token's K/V must already be written at position lengths - 1).
      save_residuals: also return the base-2 LSE [batch, q_heads] fp32
        (-inf where lengths == 0).
      sliding_window: attend only positions >= lengths - window.
      logit_softcap: scores become cap * tanh(score / cap).
      ring_buffer: the cache is a rolling buffer: position p at row p %
        max_seq, and ``lengths`` counts every position written (it may pass
        max_seq). Requires the window, which the ring (less the sink
        region) must hold, and a 128-multiple max_seq.
      attention_sinks: StreamingLLM sinks in front of a ring: rows [0,
        ceil_to(sinks, 128)) hold positions [0, sinks), always attended.
      auto_split: the JAX package's opt-in flash-decoding gate. Without
        masks or residuals, where ``should_split_decode`` fires, each
        sequence is split at least the gate's count of ways: on the card
        the larger of that count and the kernel's own ``decode_kv_splits``
        count (the gate's at most 4 splits alone leave most SMs idle at the
        small batches where it fires), on the CPU the gate's count (the
        plain split path). Otherwise, and with ``auto_split=False``, the
        kernel keeps its own count. Either choice moves only the order in
        which the output's sums are taken.

    Returns:
      [batch, q_heads, head_dim] in q's dtype, plus the LSE if asked.
    """
    return _decode(q, k_cache, v_cache, lengths, sm_scale=sm_scale, save_residuals=save_residuals,
                   sliding_window=sliding_window, logit_softcap=logit_softcap, ring_buffer=ring_buffer,
                   attention_sinks=attention_sinks, auto_split=auto_split)


def should_split_decode(batch: int, num_kv_heads: int, max_seq: int, block_kv: int) -> int:
    """The JAX package's flash-decoding gate (0 = no split): a split count
    of at most 4 that divides max_seq, for at most 16 batch x kv-head rows
    over at least 8192 rows. ``decode_attention(auto_split=True)`` asks it
    with block_kv = DECODE_RUN, the rows a step of K6 copies."""
    if batch * num_kv_heads > 16 or max_seq < 8192:
        return 0
    max_by_len = max(1, max_seq // (2 * block_kv))
    splits = min(4, max_by_len)
    while splits > 1 and max_seq % splits:
        splits -= 1
    return splits if splits > 1 else 0


def decode_attention_split(q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor, *, num_splits: int = 4,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Flash-decoding with ``num_splits`` parts a sequence: K6 (K6q over a
    QuantizedTensor cache) launched with that kv split, its parts merged in
    the same launch, and no copy of the cache. Arguments as
    ``decode_attention``; max_seq must divide into ``num_splits``, as in the
    JAX package. On the CPU, ``decode_split_plain``."""
    k_vals = split_quant(k_cache)[0]
    if num_splits < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")
    if k_vals.ndim == 4 and k_vals.shape[2] % num_splits:
        raise ValueError(f"max_seq={k_vals.shape[2]} % num_splits={num_splits} != 0")
    return _decode(q, k_cache, v_cache, lengths, sm_scale=sm_scale, num_splits=num_splits)


def _decode(q, k_cache, v_cache, lengths, *, sm_scale=None, save_residuals=False, sliding_window=None,
            logit_softcap=None, ring_buffer=False, attention_sinks=0, auto_split=False, num_splits=None):
    """decode_attention's checks and launch; ``num_splits`` fixes the kv
    split, else ``decode_kv_splits`` (at least ``auto_split``'s count)."""
    k_vals, k_scales = split_quant(k_cache)
    v_vals, v_scales = split_quant(v_cache)
    if q.ndim != 3 or k_vals.ndim != 4:
        raise ValueError("expected q [batch, heads, head_dim] and a [batch, heads, seq, head_dim] cache")
    batch, num_q_heads, head_dim = q.shape
    _, num_kv_heads, max_seq, _ = k_vals.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if k_vals.shape != v_vals.shape or (k_scales is None) != (v_scales is None):
        raise ValueError(f"k/v cache mismatch: {tuple(k_vals.shape)} vs {tuple(v_vals.shape)}")
    if k_vals.shape[0] != batch or k_vals.shape[3] != head_dim:
        raise ValueError(f"q/cache shape mismatch: {tuple(q.shape)} vs {tuple(k_vals.shape)}")
    if k_scales is not None and not k_scales.shape == v_scales.shape == (batch, num_kv_heads, max_seq, 1):
        raise ValueError(f"scales {tuple(k_scales.shape)} / {tuple(v_scales.shape)} != {(batch, num_kv_heads, max_seq, 1)}")
    if lengths.shape != (batch,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({batch},)")
    # The JAX wrapper's checks (ops/decode.py:357-392).
    if attention_sinks and not ring_buffer:
        raise ValueError("attention_sinks requires ring_buffer=True")
    if ring_buffer:
        if sliding_window is None:
            raise ValueError("ring_buffer requires sliding_window")
        if max_seq % 128:
            raise ValueError(f"ring_buffer requires a 128-multiple buffer, got {max_seq}")
        ring_cap = max_seq - (ceil_to(attention_sinks, 128) if attention_sinks else 0)
        if sliding_window > ring_cap:
            raise ValueError(f"ring region ({ring_cap} of buffer {max_seq}) must hold the whole window ({sliding_window})")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    masks = dict(sliding_window=sliding_window, logit_softcap=logit_softcap, ring_buffer=ring_buffer,
                 attention_sinks=attention_sinks)
    gate = 0
    if num_splits is None and auto_split and not save_residuals and not any(masks.values()):
        gate = should_split_decode(batch, num_kv_heads, max_seq, DECODE_RUN)
    if q.device.type == "cpu":
        if num_splits or gate:
            return decode_split_plain(q, k_cache, v_cache, lengths, num_splits or gate, sm_scale=sm_scale)
        return decode_attention_plain(
            q, k_cache, v_cache, lengths, sm_scale=sm_scale, save_residuals=save_residuals, **masks
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, got {q.device}")

    payload = _build.kv_payload_code("decode_attention", head_dim, q, k_vals, v_vals, k_scales, v_scales)
    if lengths.device != q.device:
        raise ValueError(f"lengths on {lengths.device}, q on {q.device}")
    q, k_vals, v_vals = (_build.unit_last_stride(x) for x in (q, k_vals, v_vals))
    check_tma_rows("decode_attention", k_vals, v_vals)
    lengths = _build.as_int32(lengths)
    out = torch.empty((batch, num_q_heads, head_dim), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch, num_q_heads), dtype=torch.float32, device=q.device)
        if save_residuals else None
    )
    if out.numel():
        group = num_q_heads // num_kv_heads
        span = decode_span_rows(max_seq, sliding_window=sliding_window, ring_buffer=ring_buffer)
        splits = num_splits or max(gate, decode_kv_splits(batch, num_kv_heads, group, span, sm_count(q.device)))
        ws, ws_ptr, tickets = split_buffers(q.device, batch, num_q_heads, num_kv_heads, head_dim, splits)
        lib = _build.kernels()
        with _build.on_device(q.device):
            err = lib.fat_decode(
                q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
                None if k_scales is None else k_scales.data_ptr(),
                None if v_scales is None else v_scales.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), lengths.data_ptr(), ws_ptr, tickets,
                _build.int64_tuple_array((
                    batch, num_q_heads, num_kv_heads, max_seq, head_dim, q.stride(0), q.stride(1),
                    mask_window(sliding_window), int(ring_buffer), attention_sinks, splits,
                    _build.DTYPE_CODES[q.dtype], payload, *k_vals.stride()[:3], *v_vals.stride()[:3],
                    *scale_strides(k_scales, v_scales), 0, 0, 0, 0, 0, 0, 0,
                )),
                sm_scale * LOG2E, softcap2(logit_softcap), _build.current_stream(q.device),
            )
        _build.check(err, "decode_attention (K6)")
        decode_attention.last_grid = (splits, decode_blocks(batch, num_kv_heads, group, splits))
        if k_scales is None:
            decode_attention.launches += 1
        else:
            decode_attention.quant_launches += 1
    return (out, lse) if save_residuals else out


counter(decode_attention, "launches", "K6", "decode_kernel")
counter(decode_attention, "quant_launches", "K6q", "decode_kernel")
decode_attention.last_grid = None  # (splits, blocks) of the last launch
