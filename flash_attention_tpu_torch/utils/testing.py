"""Seeded input generation and oracle-diff checking.

Counterpart of the JAX package's ``utils/testing.py``: inputs uniform in
(-0.5, 0.5) and a pass bar of max-abs-diff < 0.1 against the fp32 oracle.
The inputs come from numpy's ``default_rng(seed)``, so the same seed gives
the same numbers on any device and in either package's tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The pass bar: max abs diff < 0.1 against the fp32 oracle.
REFERENCE_TOLERANCE = 0.1


def make_qkv(
    seed: int,
    batch: int,
    num_q_heads: int,
    seq: int,
    head_dim: int,
    *,
    num_kv_heads: int | None = None,
    kv_seq: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
):
    """Seeded U(-0.5, 0.5) q [B, Hq, seq, D] and k, v [B, Hkv, kv_seq, D] on
    ``device`` (the card by default)."""
    num_kv_heads = num_kv_heads or num_q_heads
    kv_seq = kv_seq or seq
    rng = np.random.default_rng(seed)
    shapes = [
        (batch, num_q_heads, seq, head_dim),
        (batch, num_kv_heads, kv_seq, head_dim),
        (batch, num_kv_heads, kv_seq, head_dim),
    ]
    return tuple(
        torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(device=device, dtype=dtype)
        for s in shapes
    )


@dataclasses.dataclass
class DiffReport:
    max_abs_diff: float
    mean_abs_diff: float
    tolerance: float

    @property
    def passed(self) -> bool:
        return self.max_abs_diff < self.tolerance

    def __str__(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        return (
            f"[{status}] max_abs_diff={self.max_abs_diff:.6f} "
            f"mean_abs_diff={self.mean_abs_diff:.6f} (tol {self.tolerance})"
        )


def diff_report(got: torch.Tensor, want: torch.Tensor, tolerance: float = REFERENCE_TOLERANCE) -> DiffReport:
    d = (got.float() - want.float().to(got.device)).abs()
    return DiffReport(
        max_abs_diff=float(d.max()) if d.numel() else 0.0,
        mean_abs_diff=float(d.mean()) if d.numel() else 0.0,
        tolerance=tolerance,
    )


def assert_close(got: torch.Tensor, want: torch.Tensor, tolerance: float = REFERENCE_TOLERANCE, msg: str = ""):
    rep = diff_report(got, want, tolerance)
    assert rep.passed, f"{msg} {rep}"
    return rep
