"""Rotary position embeddings (decode-aware).

Counterpart of the JAX package's ``models/rope.py``: angles in fp32, the
even/odd feature pairs rotated, the result cast back to the input's dtype.
``apply_rope`` is the plain version; the serving paths rotate q and k in
one launch of ``ops.fused.rope`` (F2), which reads the same frequency table.
"""

from __future__ import annotations

import functools

import torch


def rope_frequencies(head_dim: int, *, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


@functools.lru_cache(maxsize=None)
def rope_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` built once per (head_dim, theta, device) and
    kept: a decode step no longer rebuilds it. Its first use on a device
    must not be inside a CUDA-graph capture, which would record the build
    without running it (the decode programs run each block eagerly first)."""
    return rope_frequencies(head_dim, theta=theta, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotate [..., seq, head_dim] by per-position angles.

    positions: integers broadcastable to [..., seq] — absolute token
    positions, so prefill and single-token decode share one code path.
    """
    head_dim = x.shape[-1]
    freqs = rope_table(head_dim, float(theta), x.device)  # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., seq, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
