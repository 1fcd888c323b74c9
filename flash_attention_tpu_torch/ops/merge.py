"""Partial-attention merge (log-sum-exp combine), plain PyTorch.

Counterpart of the JAX package's ``ops/merge.py``, which has no kernel
either: partial outputs over disjoint KV ranges, each already normalised by
its own softmax sum, combine into the full result through their base-2 LSE
(``lse = m + log2(l)``, the residual the kernels emit). A part with
``lse = -inf`` is an empty range and contributes nothing; when every part is
empty the output is 0 and the merged LSE is ``-inf``. The combine runs in
fp32 and casts the output back to the parts' dtype.
"""

from __future__ import annotations

import torch


def merge_partial_attention(o_parts: torch.Tensor, lse_parts: torch.Tensor, *, axis: int = 0):
    """Merge normalised partial attention outputs stacked along ``axis``.

    Args:
      o_parts: [..., q, d] partial outputs stacked along ``axis``.
      lse_parts: their base-2 LSE, the shape of ``o_parts`` without d.
      axis: the stacking axis as a position in ``o_parts``; a negative axis
        is counted against ``o_parts``' rank, not ``lse_parts``'.

    Returns:
      (o, lse): the merged output in ``o_parts``' dtype with the split axis
      removed, and the merged base-2 LSE (fp32).
    """
    axis = range(o_parts.ndim)[axis]  # normalise; raises when out of range
    if axis >= lse_parts.ndim:
        raise ValueError(f"axis {axis} must index a shared leading dim; lse_parts has rank {lse_parts.ndim}")
    if lse_parts.shape != o_parts.shape[:-1]:
        raise ValueError(f"lse_parts shape {tuple(lse_parts.shape)} != o_parts shape minus d {tuple(o_parts.shape[:-1])}")
    o32 = o_parts.movedim(axis, 0).float()
    lse = lse_parts.movedim(axis, 0).float()
    m = lse.amax(dim=0)
    # All parts empty: exp2(-inf - -inf) would be NaN.
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp2(lse - m_safe)
    denom = w.sum(dim=0)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = ((w / denom_safe)[..., None] * o32).sum(dim=0)
    lse_out = torch.where(denom == 0.0, -torch.inf, m + torch.log2(denom_safe))
    return o.to(o_parts.dtype), lse_out


def merge_two(o_a: torch.Tensor, lse_a: torch.Tensor, o_b: torch.Tensor, lse_b: torch.Tensor):
    """Two-way combine: ``merge_partial_attention`` of two parts without
    the stack. Returns (o in ``o_a``'s dtype, lse)."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    wa = torch.exp2(lse_a - m_safe)
    wb = torch.exp2(lse_b - m_safe)
    denom = wa + wb
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = (wa[..., None] * o_a.float() + wb[..., None] * o_b.float()) / denom_safe[..., None]
    lse = torch.where(denom == 0.0, -torch.inf, m + torch.log2(denom_safe))
    return o.to(o_a.dtype), lse
