"""Single-token decode attention: kernel K6 (csrc/decode.cu) and its plain version.

Replaces ``flash_attention_tpu/ops/decode.py:_decode_kernel``, reached from
``decode_attention`` (:299), on bf16, fp16 and fp32 caches. What bounds the
kernel on an H100 (the bytes of the cache read) and what its design does
about it is written at the top of csrc/decode.cu.

``decode_attention`` runs the plain PyTorch version for CPU tensors and the
CUDA kernel for CUDA tensors; there is no fallback from one to the other.
``decode_attention.launches`` counts kernel launches.

``save_residuals`` also returns the base-2 LSE, which the kernel body shares
with the paged decode K7 (ops/paged.py). Quantized caches, sliding window,
softcap, ring buffer, attention sinks and ``decode_attention_split`` are
queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import LOG2E, M_FLOOR, MASK_VALUE


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float,
    save_residuals: bool = False,
):
    """The function K6 computes, in plain fp32 PyTorch: each row of q
    attends to rows [0, lengths[b]) of its kv head's cache; output 0 (and
    base-2 LSE -inf) where lengths[b] == 0."""
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads, max_seq = k_cache.shape[1], k_cache.shape[2]
    group = num_q_heads // num_kv_heads
    qg = q.float().reshape(batch, num_kv_heads, group, head_dim)
    s2 = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * (sm_scale * LOG2E)
    live = torch.arange(max_seq, device=q.device)[None, :] < lengths.to(q.device)[:, None]
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
):
    """Single-token decode attention over a dense KV cache.

    Args:
      q: [batch, q_heads, head_dim] current-token queries.
      k_cache, v_cache: [batch, kv_heads, max_seq, head_dim] (any batch, head
        and row strides); q_heads % kv_heads == 0.
      lengths: [batch] integer — valid KV prefix per sequence (the new
        token's K/V must already be written at position lengths - 1).
      save_residuals: also return the base-2 LSE [batch, q_heads] fp32
        (-inf where lengths == 0).

    Returns:
      [batch, q_heads, head_dim] in q's dtype, plus the LSE if asked.
    """
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError("expected q [batch, heads, head_dim] and a [batch, heads, seq, head_dim] cache")
    batch, num_q_heads, head_dim = q.shape
    _, num_kv_heads, max_seq, _ = k_cache.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache shape mismatch: {tuple(k_cache.shape)} vs {tuple(v_cache.shape)}")
    if k_cache.shape[0] != batch or k_cache.shape[3] != head_dim:
        raise ValueError(f"q/cache shape mismatch: {tuple(q.shape)} vs {tuple(k_cache.shape)}")
    if lengths.shape != (batch,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({batch},)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, lengths, sm_scale=sm_scale, save_residuals=save_residuals
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, got {q.device}")

    _build.check_operands("decode_attention", head_dim, q, k_cache, v_cache)
    if lengths.device != q.device:
        raise ValueError(f"lengths on {lengths.device}, q on {q.device}")
    q, k_cache, v_cache = (_build.unit_last_stride(x) for x in (q, k_cache, v_cache))
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
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), lengths.data_ptr(), batch, num_q_heads, num_kv_heads, max_seq, head_dim,
                q.stride(0), q.stride(1),
                k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                sm_scale * LOG2E, _build.DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(err, "decode_attention (K6)")
        decode_attention.launches += 1
    return (out, lse) if save_residuals else out


decode_attention.launches = 0
