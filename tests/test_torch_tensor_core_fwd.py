"""The Python side of K1 / K1d's tensor-core body (csrc/flash_fwd_sm90.cu).

What the CPU can hold of it: the function it computes, ``flash_attention``'s
output and base-2 LSE (its plain version on the CPU) against the JAX
package's ``flash_attention`` (its Pallas kernel in interpret mode) at
lengths across the body's 64- and 128-row tile edges, GQA groups 1, 4 and
8, q_len < kv_len, and window / softcap / segment-id masks; the route by
dtype, window and segment ids; the q tile its grid takes; the operands it
hands to TMA (only misaligned ones copied); the 128-row tiles' segment skip
(a kv tile is walked when either 64-row half of the q tile meets it); that
a bf16 / fp16 call on the CPU launches nothing; and that the new sources are
built and name nothing of the JAX package. The kernel itself runs only on
the card (chip_smoke.py phases 3, 12, 15 and 18).

Tolerances: fp32 port against JAX 1e-4 for the output and the LSE (the
same math summed in another order; the base-2 LSE is of magnitude
log2(kv_len) < 10).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops import flash_attention as fa
from flash_attention_tpu_torch.ops.common import (
    SEGMENT_TILE,
    segment_tile_ranges,
    tma_aligned,
    tma_operands,
    visible_mask,
)
from flash_attention_tpu_torch.ops.flash_attention import BAND_MAX_WINDOW, flash_attention, fwd_q_tile, fwd_route

FP32_TOL = 1e-4
D = 32
H100_SMS = 132


def _inputs(seed, batch, hq, hkv, q_len, kv_len, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-0.5, 0.5, (batch, hq, q_len, D)) * q_scale).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (batch, hkv, kv_len, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (batch, hkv, kv_len, D)).astype(np.float32)
    return q, k, v


def _docs(batch, seq, cuts):
    """Segment ids [batch, seq] int32: a new document at each of ``cuts``."""
    ids = np.zeros((batch, seq), np.int32)
    for i, cut in enumerate(cuts):
        ids[:, cut:] = i + 1
    return ids


def _diff(got, want) -> float:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), "non-finite entries differ"
    assert np.array_equal(got[~fin], want[~fin])
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


# hq, hkv, q_len, kv_len, causal, masks: each length either side of the
# 64- and 128-row tiles, at GQA groups 1, 4 and 8.
EDGE_CASES = [
    pytest.param(2, 2, 63, 63, True, {}, id="mha-63"),
    pytest.param(4, 1, 64, 64, True, {}, id="gqa4-64"),
    pytest.param(8, 1, 65, 65, True, {}, id="gqa8-65"),
    pytest.param(2, 2, 127, 127, True, {}, id="mha-127"),
    pytest.param(8, 1, 128, 128, True, {}, id="gqa8-128"),
    pytest.param(4, 1, 129, 129, True, {}, id="gqa4-129"),
    pytest.param(4, 1, 255, 255, True, {}, id="gqa4-255"),
    pytest.param(2, 2, 257, 257, True, {}, id="mha-257"),
    pytest.param(8, 1, 257, 257, True, {}, id="gqa8-257"),
    pytest.param(4, 1, 63, 129, True, {}, id="gqa4-q63-over-kv129"),
    pytest.param(8, 1, 65, 257, True, {}, id="gqa8-q65-over-kv257"),
    pytest.param(2, 2, 1, 255, True, {}, id="mha-q1-over-kv255"),
    pytest.param(4, 1, 129, 65, False, {}, id="gqa4-noncausal-q129-kv65"),
    pytest.param(4, 1, 129, 129, True, dict(sliding_window=63), id="gqa4-129-window63"),
    pytest.param(2, 2, 257, 257, True, dict(sliding_window=65, logit_softcap=5.0), id="mha-257-window65-softcap"),
    pytest.param(8, 1, 127, 127, True, dict(sliding_window=1), id="gqa8-127-window1"),
    pytest.param(4, 1, 257, 257, True, dict(segment_ids=(100, 190)), id="gqa4-257-documents"),
    pytest.param(2, 2, 255, 255, True, dict(sliding_window=100, segment_ids=(64, 129)), id="mha-255-window-documents"),
]


@pytest.mark.parametrize("hq,hkv,q_len,kv_len,causal,masks", EDGE_CASES)
def test_forward_and_lse_match_jax_across_tile_edges(hq, hkv, q_len, kv_len, causal, masks):
    masks = dict(masks)
    q, k, v = _inputs(q_len * 1000 + kv_len, 1, hq, hkv, q_len, kv_len, 8.0 if "logit_softcap" in masks else 1.0)
    cuts = masks.pop("segment_ids", None)
    ids = None if cuts is None else _docs(1, kv_len, cuts)
    kw = dict(causal=causal, save_residuals=True, **masks)
    t_out, t_lse = flash_attention(*map(torch.from_numpy, (q, k, v)), segment_ids=None if ids is None else
                                   torch.from_numpy(ids), **kw)
    j_out, j_lse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), segment_ids=None if ids is None else
                                       jnp.asarray(ids), **kw)
    assert _diff(t_out, j_out) <= FP32_TOL
    assert _diff(t_lse, j_lse) <= FP32_TOL


@pytest.mark.parametrize(
    "dtype,window,segments,want",
    [
        (torch.bfloat16, None, False, ("K1", "tensor_core")),
        (torch.float16, None, False, ("K1", "tensor_core")),
        (torch.float32, None, False, ("K1", "fma")),
        (torch.bfloat16, BAND_MAX_WINDOW, False, ("K2", "fma")),
        (torch.float16, 1, False, ("K2", "fma")),
        (torch.bfloat16, BAND_MAX_WINDOW + 1, False, ("K1", "tensor_core")),
        (torch.bfloat16, 4096, False, ("K1", "tensor_core")),
        (torch.bfloat16, 63, True, ("K1d", "tensor_core")),
        (torch.float16, None, True, ("K1d", "tensor_core")),
        (torch.float32, 4096, True, ("K1d", "fma")),
    ],
)
def test_forward_route_by_dtype_window_and_segments(dtype, window, segments, want):
    assert fwd_route(dtype, window, segments) == want


def test_paged_prefill_keeps_the_fma_body():
    """K8's C entry runs flash_fwd.cu's own body in every dtype; only
    fat_flash_fwd (K1, K1d) reaches the tensor-core body."""
    src = (_build.CSRC_DIR / "flash_fwd.cu").read_text()
    paged = src[src.index('extern "C" int fat_paged_prefill'):]
    dense = src[src.index('extern "C" int fat_flash_fwd'):src.index('extern "C" int fat_paged_prefill')]
    assert "sm90_fwd" not in paged and "sm90_fwd" in dense


@pytest.mark.parametrize(
    "batch,heads,q_len,num_sms,want",
    [
        (1, 32, 256, H100_SMS, 64),  # the serving chunk: 64 blocks of 128 rows < 132 SMs
        (1, 32, 2048, H100_SMS, 128),  # phase 14's training shape: 512 blocks
        (1, 32, 8192, H100_SMS, 128),
        (1, 32, 512, H100_SMS, 64),  # 4 tiles x 32 heads = 128 blocks of 128 rows < 132 SMs
        (1, 33, 512, H100_SMS, 128),  # 4 x 33 = 132 blocks: one an SM
        (8, 4, 100, H100_SMS, 64),
        (2, 66, 128, H100_SMS, 128),
        (1, 1, 1, H100_SMS, 64),
    ],
)
def test_fwd_q_tile_takes_128_rows_only_where_they_fill_the_card(batch, heads, q_len, num_sms, want):
    assert fwd_q_tile(batch, heads, q_len, num_sms) == want
    blocks128 = -(-q_len // 128) * batch * heads
    assert (want == 128) == (blocks128 >= num_sms)


def test_cache_views_go_to_tma_without_a_copy():
    """The serving path's operands: K / V as slot 3 of a [8, 8, 2048, 128]
    cache up to kv_len, q as a [B, S, H, D] projection seen as [B, H, S,
    D]; a row stride that is no multiple of 16 bytes is copied."""
    cache = torch.zeros(8, 8, 2048, 128, dtype=torch.bfloat16)
    k = cache[3:4, :, :1000]
    q = torch.zeros(1, 256, 32, 128, dtype=torch.bfloat16).transpose(1, 2)
    odd = torch.zeros(1, 4, 100, 36, dtype=torch.bfloat16)[..., :32]  # rows 72 bytes apart
    assert tma_aligned(k) and tma_aligned(q) and not tma_aligned(odd)
    out = tma_operands(q, k, odd)
    assert out[0] is q and out[1] is k and out[2] is not odd
    assert torch.equal(out[2], odd) and out[2].is_contiguous()


def _kv_tiles_walked(q_rng, kv_rng, b, m0, q_rows, kv_tiles):
    """The kv tiles (of 64 rows) the tensor-core forward walks for the q tile
    of ``q_rows`` rows at m0: those whose id range meets the range of either
    64-row half (csrc/flash_fwd_sm90.cu next_live)."""
    nq = q_rng.shape[1]
    halves = [i for i in (m0 // SEGMENT_TILE, m0 // SEGMENT_TILE + 1) if i < nq][: q_rows // SEGMENT_TILE]

    def meet(iq, ikv):
        qr, kr = q_rng[b, iq], kv_rng[b, ikv]
        return bool(qr[0] <= kr[1] and kr[0] <= qr[1])

    return {n for n in range(kv_tiles) if any(meet(iq, n) for iq in halves)}


@pytest.mark.parametrize("q_rows", [64, 128])
@pytest.mark.parametrize(
    "seq,cuts,cuts_b", [(257, (100, 190), (7,)), (1000, (130, 131, 600), (500, 900)), (300, (64, 128, 192), (65, 129))]
)
def test_segment_skip_of_128_row_tiles_keeps_every_visible_pair(q_rows, seq, cuts, cuts_b):
    """Every (row, column) pair with equal ids lies in a kv tile the walk
    takes; for documents laid end to end the id ranges are exact, so the
    walk takes no other tile."""
    ids = torch.from_numpy(np.concatenate([_docs(1, seq, cuts), _docs(1, seq, cuts_b)]))
    rng = segment_tile_ranges(ids)
    same = visible_mask(seq, seq, "cpu", causal=False, segments=(ids, ids))
    kv_tiles = -(-seq // SEGMENT_TILE)
    for b in range(2):
        for m0 in range(0, seq, q_rows):
            walked = _kv_tiles_walked(rng, rng, b, m0, q_rows, kv_tiles)
            rows = same[b, m0:m0 + q_rows]
            needed = {int(c) // SEGMENT_TILE for c in torch.nonzero(rows.any(0)).flatten()}
            assert needed <= walked
            assert walked == needed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("masks", [{}, dict(sliding_window=100), dict(segment_ids="docs")], ids=["plain", "window", "docs"])
def test_cpu_half_precision_forward_launches_nothing(dtype, masks):
    """A CPU call takes the plain version: no forward kernel is counted."""
    masks = dict(masks)
    if masks.get("segment_ids") == "docs":
        masks["segment_ids"] = torch.from_numpy(_docs(1, 129, (40,)))
    q = torch.randn(1, 8, 129, D).to(dtype)
    k = torch.randn(1, 2, 129, D).to(dtype)
    counts = [getattr(flash_attention, c) for c in fa._COUNTERS.values()]
    out, lse = flash_attention(q, k, k, causal=True, save_residuals=True, **masks)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all()) and lse.dtype == torch.float32
    assert [getattr(flash_attention, c) for c in fa._COUNTERS.values()] == counts


def test_tensor_core_sources_are_built_and_name_no_jax_module():
    """csrc/flash_fwd_sm90.cu and the headers the tensor-core bodies share
    are in the kernel library's build, and none names a path or module of
    the JAX package."""
    sources = {p.name for p in _build.CSRC_DIR.glob("*.cu")}
    headers = {p.name for p in _build.CSRC_DIR.glob("*.cuh")}
    assert {"flash_fwd_sm90.cu", "flash_bwd_sm90.cu"} <= sources
    assert {"sm90_common.cuh", "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh"} <= headers
    named = re.compile(r"flash_attention_tpu(?=[/.])|#include\s*[<\"]jax")
    for name in ("flash_fwd_sm90.cu", "flash_fwd_sm90.cuh", "sm90_common.cuh", "flash_bwd_sm90.cu"):
        text = (_build.CSRC_DIR / name).read_text()
        assert not named.search(text), name
    for name in ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu"):
        assert '#include "sm90_common.cuh"' in (_build.CSRC_DIR / name).read_text()
