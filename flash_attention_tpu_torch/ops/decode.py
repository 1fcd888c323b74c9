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
with the paged decode K7 (ops/paged.py). Sliding window, softcap, ring
buffer, attention sinks and ``decode_attention_split`` are queued in
ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import LOG2E, M_FLOOR, MASK_VALUE
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
    base-2 LSE -inf) where lengths[b] == 0. A quantized cache is
    dequantized to fp32 first."""
    if isinstance(k_cache, QuantizedTensor):
        k_cache, v_cache = dequantize(k_cache), dequantize(v_cache)
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
        and row strides); q_heads % kv_heads == 0. Either plain tensors of
        q's dtype or QuantizedTensors (int8 / fp8 payload with fp32 scales
        [batch, kv_heads, max_seq, 1]), dequantized inside the kernel.
      lengths: [batch] integer — valid KV prefix per sequence (the new
        token's K/V must already be written at position lengths - 1).
      save_residuals: also return the base-2 LSE [batch, q_heads] fp32
        (-inf where lengths == 0).

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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, lengths, sm_scale=sm_scale, save_residuals=save_residuals
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
                sm_scale * LOG2E, _build.DTYPE_CODES[q.dtype], payload,
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
