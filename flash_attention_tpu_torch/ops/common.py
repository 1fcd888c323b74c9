"""Shared numerics constants of the attention kernels.

The contract of the JAX package's ``ops/common.py``: fp32 accumulators, an
exp2-domain softmax with log2(e) folded into the scale, and a large finite
negative mask value rather than -inf, so exp2 of a masked score underflows to
exactly 0. The CUDA sources (csrc/common.cuh) carry the same three numbers.
Also the masks' shared pieces: the visibility predicate the plain versions
apply, and the packed-sequence ids' checks and tile ranges; and what the
tensor-core bodies (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu) need of
their operands: the dtypes they take and the alignment TMA reads.
"""

from __future__ import annotations

import functools

import torch

LOG2E = 1.4426950408889634
# -0.7 * float32 max, as the JAX package computes it from jnp.finfo.
MASK_VALUE = -0.7 * 3.4028234663852886e38
# Floor for the running row max: a fully masked row's max is
# MASK_VALUE * scale2, and exp2 of a difference of two such huge values can
# round to +inf. With m floored here, masked scores underflow to 0 instead.
M_FLOOR = -1e30


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# Rows per tile of the kernels' segment skip (csrc/flash_fwd.cu and
# csrc/flash_bwd.cu tile q and kv by 64 rows).
SEGMENT_TILE = 64


def segment_pair(segment_ids, batch: int, q_len: int, kv_len: int):
    """Packed-sequence ids as the (q_ids [B, Sq], kv_ids [B, Skv]) pair, or
    None, with the JAX package's checks (ops/flash_attention.py:1780-1799):
    a single [B, S] array serves both sides and needs q_seq == kv_seq."""
    if segment_ids is None:
        return None
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        if q_len != kv_len:
            raise ValueError(
                "single segment_ids array requires q_seq == kv_seq; pass "
                "a (q_ids, kv_ids) pair for cross-length attention"
            )
        q_ids = kv_ids = segment_ids
    if tuple(q_ids.shape) != (batch, q_len):
        raise ValueError(f"q segment_ids shape {tuple(q_ids.shape)} != {(batch, q_len)}")
    if tuple(kv_ids.shape) != (batch, kv_len):
        raise ValueError(f"kv segment_ids shape {tuple(kv_ids.shape)} != {(batch, kv_len)}")
    return q_ids, kv_ids


def visible_mask(q_len: int, kv_len: int, device, *, causal: bool, window=None, sinks: int = 0, segments=None):
    """The kernels' visibility of (row, column) pairs, bool [B or 1, Sq, Skv],
    or None when every pair is visible: causal end-aligned (row i at
    position i + kv_len - q_len sees columns j <= position), a window (also
    j > position - window, or j < sinks), and segment ids (equal ids only),
    combined by AND."""
    ok = None
    if causal:
        row = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
        col = torch.arange(kv_len, device=device)[None, :]
        ok = col <= row
        if window is not None:
            ok = ok & ((col > row - window) | (col < sinks))
        ok = ok[None]
    if segments is not None:
        q_ids, kv_ids = segments
        same = q_ids.to(device)[:, :, None] == kv_ids.to(device)[:, None, :]
        ok = same if ok is None else ok & same
    return ok


def segment_tile_ranges(ids: torch.Tensor) -> torch.Tensor:
    """Each SEGMENT_TILE-row tile's smallest and largest id, int32 [B,
    ceil(S / SEGMENT_TILE), 2] contiguous: what the kernels' segment skip
    reads. The last tile's missing rows repeat its last id, so they widen no
    range."""
    batch, seq = ids.shape
    pad = ceil_to(seq, SEGMENT_TILE) - seq
    if pad:
        ids = torch.cat([ids, ids[:, -1:].expand(batch, pad)], dim=1)
    tiles = ids.reshape(batch, -1, SEGMENT_TILE)
    return torch.stack([tiles.amin(dim=-1), tiles.amax(dim=-1)], dim=-1).to(torch.int32).contiguous()


def segment_operands(segments, device) -> list:
    """The kernels' segment arguments for a (q_ids, kv_ids) pair: the ids as
    int32 contiguous on ``device`` and each tile's id range, or four Nones
    without segments."""
    if segments is None:
        return [None] * 4
    q_ids, kv_ids = (ids.to(device=device, dtype=torch.int32).contiguous() for ids in segments)
    return [q_ids, kv_ids, segment_tile_ranges(q_ids), segment_tile_ranges(kv_ids)]


def mask_window(sliding_window: int | None) -> int:
    """The kernels' window argument: 0 for none."""
    return 0 if sliding_window is None else int(sliding_window)


def softcap2(logit_softcap: float | None) -> float:
    """The kernels' softcap argument: cap * log2(e), the cap in the exp2
    domain of their scores, or 0 for none."""
    return 0.0 if logit_softcap is None else float(logit_softcap) * LOG2E


# dtypes whose K1, K1d, K3, K4 and K5 run on the tensor cores
# (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu); fp32 keeps the FMA bodies.
TENSOR_CORE_DTYPES = (torch.float16, torch.bfloat16)
TMA_ALIGN = 16  # bytes: TMA's base address and stride alignment


def tma_aligned(x: torch.Tensor) -> bool:
    """Whether TMA can read ``x`` [B, H, S, D] as it lies: unit last stride,
    a 16-byte-aligned base and 16-byte-multiple strides (a dimension of
    extent 1 is never stepped over, so its stride does not count)."""
    size = x.element_size()
    return (
        x.stride(-1) == 1
        and x.data_ptr() % TMA_ALIGN == 0
        and all(n == 1 or st * size % TMA_ALIGN == 0 for n, st in zip(x.shape[:-1], x.stride()[:-1]))
    )


def tma_operands(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The operands as the tensor-core bodies take them: each one itself if
    ``tma_aligned``, else a contiguous copy (only that one is copied)."""
    return [x if tma_aligned(x) else x.clone(memory_format=torch.contiguous_format) for x in tensors]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
