"""fp32 reference ("oracle") attention.

Counterpart of the JAX package's ``ops/reference.py``: a naive, fully
materialised attention in fp32 that judges every kernel. Grouped-query heads
broadcast (kv head = q head // group), causal masking is aligned at the END
of the KV sequence (the last query row sees the last key), and ``kv_length``
masks each batch row to its valid prefix. A row that sees no key gives output
0 (and LSE -inf), the kernels' ``l == 0`` guard.

``sliding_window`` (causal only) keeps column j for row i when j > i +
(kv_len - q_len) - window; ``logit_softcap`` maps the scaled score s to
cap * tanh(s / cap) before any mask; ``segment_ids`` (packed sequences), one
[B, S] tensor or a (q_ids [B, Sq], kv_ids [B, Skv]) pair, keeps only the
pairs whose ids are equal. The masks combine by AND.
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.ops.common import LOG2E, MASK_VALUE


def _expand_kv(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected [batch, heads, seq, head_dim] inputs")
    num_q_heads, num_kv_heads = q.shape[1], k.shape[1]
    if num_q_heads % num_kv_heads:
        raise ValueError(f"Hq={num_q_heads} not a multiple of Hkv={num_kv_heads}")
    group = num_q_heads // num_kv_heads
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    return q.float(), kf, vf


def _mask(q_len, kv_len, causal, kv_length, device, sliding_window=None, segment_ids=None):
    """Boolean [B or 1, 1, Sq, Skv] visibility mask, or None."""
    if sliding_window is not None and not causal:
        raise ValueError("sliding_window requires causal=True")
    mask = None
    if causal:
        row = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
        col = torch.arange(kv_len, device=device)[None, :]
        mask = col <= row
        if sliding_window is not None:
            mask = mask & (col > row - sliding_window)
        mask = mask[None, None]
    if kv_length is not None:
        len_mask = (
            torch.arange(kv_len, device=device)[None, :]
            < kv_length.to(device)[:, None]
        )[:, None, None, :]
        mask = len_mask if mask is None else (mask & len_mask)
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids if isinstance(segment_ids, (tuple, list)) else (segment_ids, segment_ids)
        seg_mask = (q_ids.to(device)[:, :, None] == kv_ids.to(device)[:, None, :])[:, None]
        mask = seg_mask if mask is None else (mask & seg_mask)
    return mask


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    kv_length: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    segment_ids=None,
) -> torch.Tensor:
    """Naive fp32 attention over [B, H, S, D] inputs; returns [B, Hq, Sq, D].

    ``kv_length`` is an optional [B] integer tensor, the valid KV prefix per
    batch row. The output has ``out_dtype``, q's dtype by default.
    """
    qf, kf, vf = _expand_kv(q, k, v)
    q_len, kv_len, head_dim = q.shape[2], k.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / head_dim**0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    mask = _mask(q_len, kv_len, causal, kv_length, q.device, sliding_window, segment_ids)
    if mask is not None:
        scores = torch.where(mask, scores, MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    if mask is not None:
        weights = torch.where(mask.any(dim=-1, keepdim=True), weights, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vf)
    return out.to(out_dtype or q.dtype)


def reference_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    kv_length: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    segment_ids=None,
):
    """Like :func:`reference_attention`, also returning the base-2 LSE.

    The LSE is ``max + log2(sum)`` of ``2^(scores * log2e - max)``, shape
    [B, Hq, Sq] fp32, and -inf for a row that sees no key.
    """
    qf, kf, vf = _expand_kv(q, k, v)
    q_len, kv_len, head_dim = q.shape[2], k.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / head_dim**0.5
    if logit_softcap is None:
        s2 = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (sm_scale * LOG2E)
    else:
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
        s2 = logit_softcap * torch.tanh(scores / logit_softcap) * LOG2E
    mask = _mask(q_len, kv_len, causal, kv_length, q.device, sliding_window, segment_ids)
    if mask is not None:
        s2 = torch.where(mask, s2, MASK_VALUE)
    m = s2.amax(dim=-1)
    p = torch.exp2(s2 - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l[..., None]
    lse2 = m + torch.log2(l)
    if mask is not None:
        live = mask.any(dim=-1).expand_as(lse2)
        out = torch.where(live[..., None], out, 0.0)
        lse2 = torch.where(live, lse2, -torch.inf)
    return out.to(out_dtype or q.dtype), lse2
