"""The prefill chunk's body over a quantized dense slot or the rolling ring
(csrc/chunk_fwd_sm90.cu: K1q, K1r on the card) through its plain mirrors,
on the CPU.

The kernel packs a GQA group's q heads as rows (position, head)
(``chunk_rows``), cuts each block's walk (``chunk_walk``, ``fwd_walk`` over
the block's positions) into ``chunk_splits`` contiguous shares
(``chunk_shares``), one a block of a thread-block cluster, and merges the
shares' (O, m, l) partials in rank order (``chunk_merge_plain``);
``cache_attention_split_plain`` computes the chunk that way. These tests
hold the cut to the unsplit walk, the row map to every (head, position) of
the chunk, the host's split choice to the card's SM count, and the split
mirror to ``cache_attention_plain`` (fp32, the same sums in another order:
each base-2 LSE within 1e-6 of its size, and each output row within 2e-6 of
its largest value, as the repository's row-relative bars read: 16 units in
the last place of fp32, since the shares reorder sums of up to 300 terms
and 1e-6, 8 units, was reached at 1.0016e-6; the queries are drawn at a
quarter of the rows' scale so that the base-2 scores stay within ~16,
since the two products round each score differently and exp2 turns that
into up to ulp(score) ~ 2e-6 of a p at 16)
and to the JAX package's ``attention_prefill_chunk`` over JAX's own caches
(1e-5 through the output projection, as tests/test_torch_prefill_cache.py
holds the plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.ops.common import ring_layout
from flash_attention_tpu_torch.ops.flash_attention import (
    CHUNK_MAX_SPLITS,
    CHUNK_ROWS,
    KV_TILE,
    cache_attention_plain,
    cache_attention_split_plain,
    chunk_merge_plain,
    chunk_q_tiles,
    chunk_rows,
    chunk_shares,
    chunk_splits,
    chunk_walk,
    fwd_walk,
)
from flash_attention_tpu_torch.ops.quant import payload_dtype, quantize_values

FP32_TOL = 1e-5
MERGE_TOL = 1e-6  # the LSE, relative to its size
MERGE_ROW_TOL = 2e-6  # the output, relative to its row's largest value
ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")
SLOTS = 3
SLOT = 1
TORCH_PAYLOADS = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


# ---------------------------------------------------------------- the walk's shares


@pytest.mark.parametrize("sinks", [0, 4, 32])
@pytest.mark.parametrize("kv_end", [256, 4000, 4352, 4608, 9000])
def test_shares_cover_the_walk_once_in_order(sinks, kv_end):
    """17a's ring (window 4096, chunk 256; 4352 rows, 128 more with sinks)
    at a kv_end below, at and past its rows (4608 and 9000 wrap it; a chunk
    ending at 4608 straddles the ring's end), every block of every group
    size: the shares of every split count, joined, are the unsplit walk,
    each tile once and in order; at kv_end 256 the walk is shorter than the
    split and some shares are empty."""
    rows = 4352 + (128 if sinks else 0)
    ring_mod, _ = ring_layout(rows, sinks)
    t = 256
    assert ring_mod >= 4096 + t
    for group in (1, 4):
        for m0 in range(0, t * group, CHUNK_ROWS):
            walk = chunk_walk(m0, t, group, kv_end, window=4096, sinks=sinks, ring=True)
            assert walk == sorted(set(walk)) and all(n0 % KV_TILE == sinks % KV_TILE or n0 < sinks for n0 in walk)
            for splits in range(1, CHUNK_MAX_SPLITS + 1):
                shares = chunk_shares(walk, splits)
                assert len(shares) == splits
                assert [n0 for share in shares for n0 in share] == walk
                sizes = [len(share) for share in shares]
                assert max(sizes) - min(sizes) <= 1
                if len(walk) < splits:
                    assert min(sizes) == 0
    short = chunk_walk(0, t, 4, 256, window=4096, sinks=sinks, ring=True)
    assert len(short) < CHUNK_MAX_SPLITS and [] in chunk_shares(short, CHUNK_MAX_SPLITS)


def test_a_block_walks_its_positions():
    """A block of packed rows walks ``fwd_walk`` over exactly the positions
    its rows hold: the first row's position to the last one below T."""
    for group, t, m0 in ((4, 256, 0), (4, 256, 896), (1, 37, 0), (8, 255, 1920), (3, 100, 256)):
        pos, _ = chunk_rows(m0, t, group)
        live = [p for p in pos if p < t]
        assert chunk_walk(m0, t, group, 2048) == fwd_walk(live[0], live[-1] - live[0] + 1, t, 2048)
        assert chunk_walk(m0, t, group, 9000, window=4096, sinks=4, ring=True) == fwd_walk(
            live[0], live[-1] - live[0] + 1, t, 9000, window=4096, sinks=4, ring=True)


# ---------------------------------------------------------------- the (position, head) rows


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("t", [1, 37, 255, 256])
def test_every_head_and_position_is_one_row(group, t):
    """Over a kv head's blocks, every (q head of the group, position) of the
    chunk is one packed row, the rest padding past T."""
    seen = []
    for m0 in range(0, chunk_q_tiles(t, group) * CHUNK_ROWS, CHUNK_ROWS):
        pos, head = chunk_rows(m0, t, group)
        assert all(0 <= h < group for h in head)
        seen += [(h, p) for h, p in zip(head, pos) if p < t]
    assert sorted(seen) == [(h, p) for h in range(group) for p in range(t)]
    assert chunk_q_tiles(t, group) == -(-t * group // CHUNK_ROWS)


# ---------------------------------------------------------------- the host's split choice


@pytest.mark.parametrize("sms,want", [(132, 2), (114, 1), (78, 1), (256, 4), (1024, 8), (16, 1)])
def test_split_choice_at_the_chunk(sms, want):
    """The chunk q [1,32,256,128] over 8 kv heads is 64 (kv head, q tile)
    blocks: as many splits as keep one wave of one block an SM, 1 to 8."""
    assert chunk_splits(8, 256, 4, sms) == want


@pytest.mark.parametrize("sms", [66, 114, 132, 144])
@pytest.mark.parametrize("kv_heads,t,group", [(8, 256, 4), (8, 1, 4), (32, 256, 1), (32, 37, 1), (8, 64, 8),
                                              (1, 256, 32)])
def test_split_choice_fills_one_wave(sms, kv_heads, t, group):
    splits = chunk_splits(kv_heads, t, group, sms)
    base = kv_heads * chunk_q_tiles(t, group)
    assert 1 <= splits <= CHUNK_MAX_SPLITS
    assert splits == 1 or base * splits <= sms
    assert splits == CHUNK_MAX_SPLITS or base * (splits + 1) > sms


# ---------------------------------------------------------------- the merge


def test_the_merge_of_one_share_is_the_softmax():
    """One partial (acc, m, l) merges to acc / l and m + log2(l); an empty
    share (m at M_FLOOR, l 0) beside it changes nothing, bit for bit; a row
    no share saw gives 0 and -inf."""
    rng = np.random.default_rng(3)
    acc, m, l = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((6, 8), (6,), (6,)))
    l = l.abs() + 0.5
    l[2] = 0.0
    acc[2] = 0.0
    m[2] = -1e30
    empty = (torch.zeros(6, 8), torch.full((6,), -1e30), torch.zeros(6))
    out, lse = chunk_merge_plain([(acc, m, l)])
    for parts in ([empty, (acc, m, l)], [(acc, m, l), empty], [empty, (acc, m, l), empty]):
        got = chunk_merge_plain(parts)
        assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    assert torch.equal(out[2], torch.zeros(8)) and lse[2] == -torch.inf
    assert torch.allclose(out[0], acc[0] / l[0]) and torch.allclose(lse[0], m[0] + torch.log2(l[0]))


def _cache(shape, mode, seed):
    """Random fp32 rows, each scaled by its own power of two, and their
    payload and scales for ``mode`` (or the rows themselves)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=shape) * np.exp2(rng.uniform(-3, 3, size=shape[:3] + (1,))))
                         .astype(np.float32))
    if mode is None:
        return x, None
    return quantize_values(x, payload_dtype(mode))


@pytest.mark.parametrize("case", [
    dict(mode="int8", kv_end=300), dict(mode="fp8_e4m3", kv_end=160), dict(mode="fp8_e5m2", kv_end=64),
    dict(mode="int8", kv_end=300, window=100),
    dict(ring=True, sinks=4, window=96, kv_end=700, rows=512),
    dict(ring=True, sinks=32, window=96, kv_end=700, rows=512, softcap=5.0),
    dict(ring=True, sinks=0, window=96, kv_end=430, rows=256, mode="int8"),
    dict(ring=True, sinks=4, window=192, kv_end=150, rows=512),
])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_mirror_matches_the_plain_version(case, splits):
    """The shares' partials merged in rank order equal the unsplit plain
    version over the same cache: int8 / e4m3 / e5m2 dense slots (one with a
    window), rings with 0, 4 and 32 sinks before and past the window (an
    int8 one, a softcap), groups of 4 at T = 37 (a partial last block)."""
    t, d, rows = 37, 32, case.get("rows", 320)
    mode, ring, sinks = case.get("mode"), case.get("ring", False), case.get("sinks", 0)
    q = torch.from_numpy(np.random.default_rng(1).normal(scale=0.25, size=(1, 8, t, d)).astype(np.float32))
    (k, ks), (v, vs) = _cache((SLOTS, 2, rows, d), mode, 2), _cache((SLOTS, 2, rows, d), mode, 3)
    kw = dict(k_scales=ks, v_scales=vs, ring=ring, sinks=sinks, sliding_window=case.get("window"),
              logit_softcap=case.get("softcap"))
    want, want_lse = cache_attention_plain(q, k, v, torch.tensor([SLOT], dtype=torch.int32), case["kv_end"],
                                           sm_scale=d ** -0.5, save_residuals=True, **kw)
    got, lse = cache_attention_split_plain(q, k, v, SLOT, case["kv_end"], sm_scale=d ** -0.5, splits=splits, **kw)
    row_max = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    assert float(((got - want).abs() / row_max).max()) <= MERGE_ROW_TOL
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(lse)
    assert float(((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0))[fin].max()) <= MERGE_TOL


def _torch_payload(arr, mode: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if mode == "int8":
        return torch.from_numpy(arr.copy())
    return torch.from_numpy(arr.view(np.uint8).copy()).view(TORCH_PAYLOADS[mode])


def _jax_caches(mode: str, rows: int, rng):
    """A JAX cache of SLOTS slots x ``rows`` rows of random rows (quantized
    by the JAX package's quantizer for a payload), lengths 0."""
    shape = (SLOTS, ATTN["num_kv_heads"], rows, ATTN["head_dim"])
    k, v = (rng.normal(size=shape).astype(np.float32) * np.exp2(rng.uniform(-3, 3, size=shape[:3] + (1,)))
            for _ in range(2))
    lengths = jnp.zeros((SLOTS,), jnp.int32)
    if mode == "none":
        return jattn.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), k_scales=None, v_scales=None, lengths=lengths)
    qk, qv = (jquant.quantize_values(jnp.asarray(x), jquant.payload_dtype(mode)) for x in (k, v))
    return jattn.KVCache(k=qk.values, v=qv.values, k_scales=qk.scales, v_scales=qv.scales, lengths=lengths)


def _port_view(jc, mode: str):
    """JAX's cache rows as the port's tensors (k, v, k_scales, v_scales)."""
    if mode == "none":
        return torch.from_numpy(np.array(jc.k)), torch.from_numpy(np.array(jc.v)), None, None
    return (_torch_payload(jc.k, mode), _torch_payload(jc.v, mode), torch.from_numpy(np.array(jc.k_scales)),
            torch.from_numpy(np.array(jc.v_scales)))


@pytest.mark.parametrize("fields,chunks,splits", [
    (dict(kv_quant="int8"), (64, 32, 64), 2),
    (dict(kv_quant="fp8_e4m3"), (96, 64), 3),
    (dict(kv_quant="fp8_e5m2"), (64, 96), 8),
    (dict(rolling=True, sliding_window=192, attention_sinks=4), (128, 64, 128, 128), 2),
    (dict(rolling=True, sliding_window=192, attention_sinks=4, kv_quant="int8"), (128, 128, 128, 64), 4),
])
def test_split_mirror_matches_jax_chunks(fields, chunks, splits):
    """JAX's chunk prefill over its own caches (int8 / e4m3 / e5m2 dense
    slots, the ring with 4 sinks before and past the window, 16-bit and
    int8): each chunk's attention by the split mirror over JAX's cache as
    its chunk left it, through the port's output projection, within 1e-5 of
    JAX's output."""
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    jp = jattn.init_attention_params(jax.random.key(11), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(11)
    rows = 160 if not fields.get("rolling") else tattn.rolling_buffer_len(tcfg, 2048, max(chunks))
    mode = fields.get("kv_quant", "none")
    jc = _jax_caches(mode, rows, rng)
    start = 0
    for t in chunks:
        x = rng.normal(size=(1, t, ATTN["model_dim"])).astype(np.float32)
        j_out, jc = jattn.attention_prefill_chunk(jp, jcfg, jnp.asarray(x), jc, SLOT, start, start + t)
        k, v, ks, vs = _port_view(jc, mode)
        q, _, _ = tattn._project_qkv(tp, tcfg, torch.from_numpy(x), start + torch.arange(t)[None, None, :])
        o, _ = cache_attention_split_plain(
            q, k, v, SLOT, start + t, sm_scale=ATTN["head_dim"] ** -0.5, splits=splits, k_scales=ks, v_scales=vs,
            ring=tcfg.rolling, sinks=tcfg.attention_sinks, sliding_window=tcfg.sliding_window)
        d = float(np.abs(tattn._output_proj(tp, o, torch.float32).numpy() - np.asarray(j_out)).max())
        assert d <= FP32_TOL, f"chunk [{start}, {start + t}): {d}"
        start += t
