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
live rows. ``decode_attention_split`` is queued in ROADMAP.md (item 4).
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import LOG2E, M_FLOOR, MASK_VALUE, ceil_to, mask_window, softcap2
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
    if isinstance(k_cache, QuantizedTensor):
        k_cache, v_cache = dequantize(k_cache), dequantize(v_cache)
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads, max_seq = k_cache.shape[1], k_cache.shape[2]
    group = num_q_heads // num_kv_heads
    qg = q.float().reshape(batch, num_kv_heads, group, head_dim)
    if logit_softcap is None:
        s2 = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * (sm_scale * LOG2E)
    else:
        s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * sm_scale
        s2 = logit_softcap * torch.tanh(s / logit_softcap) * LOG2E
    live = visible_rows(lengths.to(q.device), max_seq, sliding_window=sliding_window, ring_buffer=ring_buffer,
                        attention_sinks=attention_sinks)
    s2 = torch.where(live[:, None, None, :], s2, MASK_VALUE)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    out = torch.where(l == 0, 0.0, acc / l).reshape(batch, num_q_heads, head_dim).to(q.dtype)
    if not save_residuals:
        return out
    lse = torch.where(l == 0, -torch.inf, m + torch.log2(l))
    return out, lse.reshape(batch, num_q_heads)


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

    Returns:
      [batch, q_heads, head_dim] in q's dtype, plus the LSE if asked.
    """
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
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, lengths, sm_scale=sm_scale, save_residuals=save_residuals, **masks
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, got {q.device}")

    payload = _build.kv_payload_code("decode_attention", head_dim, q, k_vals, v_vals, k_scales, v_scales)
    if lengths.device != q.device:
        raise ValueError(f"lengths on {lengths.device}, q on {q.device}")
    q, k_vals, v_vals = (_build.unit_last_stride(x) for x in (q, k_vals, v_vals))
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((batch, num_q_heads, head_dim), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch, num_q_heads), dtype=torch.float32, device=q.device)
        if save_residuals else None
    )
    if out.numel():
        lib = _build.kernels()
        with torch.cuda.device(q.device):
            err = lib.fat_decode(
                q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
                None if k_scales is None else k_scales.data_ptr(),
                None if v_scales is None else v_scales.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), lengths.data_ptr(),
                batch, num_q_heads, num_kv_heads, max_seq, head_dim, q.stride(0), q.stride(1),
                _build.int64_array([*k_vals.stride()[:3], *v_vals.stride()[:3], *scale_strides(k_scales, v_scales)]),
                sm_scale * LOG2E, mask_window(sliding_window), int(ring_buffer), attention_sinks,
                softcap2(logit_softcap), _build.DTYPE_CODES[q.dtype], payload,
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(err, "decode_attention (K6)")
        if k_scales is None:
            decode_attention.launches += 1
        else:
            decode_attention.quant_launches += 1
    return (out, lse) if save_residuals else out


decode_attention.launches = 0
decode_attention.quant_launches = 0
