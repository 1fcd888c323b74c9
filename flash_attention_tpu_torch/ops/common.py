"""Shared numerics constants of the attention kernels.

The contract of the JAX package's ``ops/common.py``: fp32 accumulators, an
exp2-domain softmax with log2(e) folded into the scale, and a large finite
negative mask value rather than -inf, so exp2 of a masked score underflows to
exactly 0. The CUDA sources (csrc/common.cuh) carry the same three numbers.
"""

from __future__ import annotations

LOG2E = 1.4426950408889634
# -0.7 * float32 max, as the JAX package computes it from jnp.finfo.
MASK_VALUE = -0.7 * 3.4028234663852886e38
# Floor for the running row max: a fully masked row's max is
# MASK_VALUE * scale2, and exp2 of a difference of two such huge values can
# round to +inf. With m floored here, masked scores underflow to 0 instead.
M_FLOOR = -1e30


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m
