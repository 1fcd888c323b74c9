"""The kv split of the port's decode kernels (K6, K7) and its one-launch
page write (K9, K10), on the CPU.

csrc/decode.cu cuts each sequence's live rows into ``splits`` pieces of
whole units (64-row runs, or K7's pages) and merges the pieces' partial
results in the same launch. The kernel runs only on the card (chip_smoke.py
holds it there); here the port's plain pieces stand for it:

  * ``decode_kv_splits`` at the main paths' shapes and at its edges;
  * ``decode_split_runs``, the plain mirror of the kernel's cut, walks every
    visible row exactly once, for a window, a ring, a ring with sinks and
    K7's pages of 64 and 128 rows, at lengths 0, 1 and each split edge +-1;
  * ``merge_partial_attention`` over those splits' plain partials equals
    ``decode_attention_plain``, JAX's ``decode_attention`` and JAX's
    ``decode_attention_split`` on numpy inputs from a seed;
  * ``paged_write_tokens`` and ``paged_write_tokens_multi`` leave JAX's
    lengths with one slot at capacity and one on the dump page, and a CPU
    call launches nothing.

Tolerance: fp32 throughout at 1e-5. The outputs are means of values in
(-1, 1), so fp32 sums taken in another order differ by a few units in the
last place (about 1e-7), while a row walked twice or dropped, or parts merged
without rescaling by their maxima, moves them by more than 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import decode as jdecode
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu_torch.ops import decode as tdecode
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops.common import LOG2E, MASK_VALUE, M_FLOOR
from flash_attention_tpu_torch.ops.merge import merge_partial_attention

TOL = 1e-5
D = 32
WINDOW = 300
H100_SMS = 132


# ---------------------------------------------------------------- the split count


@pytest.mark.parametrize(
    "path, batch, kv_heads, group, span, want",
    [
        ("phase 3 (K6, 8 slots x 2048 rows)", 8, 8, 4, 2048, 5),
        ("phase 5 (ModelConfig(), dense engine)", 8, 8, 4, 2048, 5),
        ("phase 8 (paged engine, 16 pages of 128)", 8, 8, 4, 16 * 128, 5),
        ("phase 15 (the ring of 4352 rows)", 8, 8, 4, 4352, 5),
        ("phase 17a (Mistral's rolling engine)", 8, 8, 4, 4352, 5),
        ("phase 17c (paged ring, window 4096 + sinks)", 8, 8, 4,
         tdecode.decode_span_rows(72 * 128, sliding_window=4096, page_size=128, attention_sinks=4), 5),
        ("batch 1", 1, 8, 4, 2048, 8),
        ("batch 1, one kv head, group 16", 1, 1, 16, 8192, 32),
        ("group 32: two query chunks", 1, 1, 32, 8192, 32),
        ("32 slots x 8192 rows", 32, 8, 4, 8192, 2),
        ("a full card already", 64, 8, 4, 2048, 1),
        ("a span under two splits", 1, 8, 4, 300, 1),
        ("a span of two splits", 1, 8, 4, 512, 2),
        ("a span under one split", 1, 8, 4, 100, 1),
    ],
)
def test_decode_kv_splits_at_the_main_paths_and_edges(path, batch, kv_heads, group, span, want):
    assert tdecode.decode_kv_splits(batch, kv_heads, group, span, H100_SMS) == want, path


def test_decode_kv_splits_bounds():
    """At least one split; never more splits than runs; no split under 256
    rows unless there is only one; and enough blocks for two an SM where
    the span allows."""
    for span in range(1, 9000, 37):
        for batch, kv_heads, group in ((1, 1, 1), (1, 8, 4), (8, 8, 4), (3, 2, 16), (2, 4, 32)):
            splits = tdecode.decode_kv_splits(batch, kv_heads, group, span, H100_SMS)
            assert 1 <= splits <= max(1, -(-span // tdecode.DECODE_RUN))
            assert splits == 1 or span // splits >= tdecode.MIN_SPLIT_ROWS
            blocks = tdecode.decode_blocks(batch, kv_heads, group, splits)
            assert blocks >= 2 * H100_SMS or splits == span // tdecode.MIN_SPLIT_ROWS or splits == 1


def test_decode_span_rows():
    assert tdecode.decode_span_rows(2048) == 2048
    assert tdecode.decode_span_rows(4352, sliding_window=4096, ring_buffer=True) == 4352
    assert tdecode.decode_span_rows(9216, sliding_window=4096) == 4096 + tdecode.DECODE_RUN
    assert tdecode.decode_span_rows(1000, sliding_window=4096) == 1000
    assert tdecode.decode_span_rows(9216, sliding_window=4096, page_size=128, attention_sinks=4) == 4096 + 256


# ---------------------------------------------------------------- the cut


# (kind, rows, unit, masks): the cache's rows (K7: pages_per_slot x page)
# and the unit a split is cut in.
KINDS = {
    "none": (512, 64, {}),
    "window": (1100, 64, dict(sliding_window=WINDOW)),
    "ring": (384, 64, dict(sliding_window=WINDOW, ring_buffer=True)),
    "ring + sinks": (512, 64, dict(sliding_window=WINDOW, ring_buffer=True, attention_sinks=3)),
    "pages of 64": (1152, 64, dict(sliding_window=WINDOW, attention_sinks=3)),
    "pages of 128": (1152, 128, dict(sliding_window=WINDOW, attention_sinks=3)),
}
SPLITS = 4


def _edge_lengths(kind: str) -> list[int]:
    """0, 1, and -1 / 0 / +1 around each split's first row and each unit
    edge, for a sequence that fills the cache and one twice as long."""
    rows, unit, masks = KINDS[kind]
    out = {0, 1}
    for length in (rows, 2 * rows):
        for runs in tdecode.decode_split_runs(length, SPLITS, rows=rows, unit=unit, **masks):
            for r0, count in runs[:1] + runs[-1:]:
                out |= {r0 - 1, r0, r0 + 1, r0 + count - 1, r0 + count, r0 + count + 1}
    return sorted(x for x in out if x >= 0)


def _walked(kind: str, length: int) -> list[np.ndarray]:
    """The rows each split walks (copies), as bool [rows] masks."""
    rows, unit, masks = KINDS[kind]
    out = []
    for runs in tdecode.decode_split_runs(length, SPLITS, rows=rows, unit=unit, **masks):
        walked = np.zeros(rows, bool)
        for r0, count in runs:
            assert 1 <= count <= tdecode.DECODE_RUN and r0 % tdecode.DECODE_RUN == 0
            assert (r0 + count - 1) // unit == r0 // unit, "a run straddles a unit (a page)"
            assert not walked[r0:r0 + count].any()
            walked[r0:r0 + count] = True
        if runs:
            assert runs[0][0] % unit == 0, "a split starts inside a unit"
        out.append(walked)
    return out


def _visible(kind: str, lengths) -> np.ndarray:
    rows, _, masks = KINDS[kind]
    masks = {k: v for k, v in masks.items() if k != "ring_buffer" or v}
    return tdecode.visible_rows(torch.tensor(lengths), rows, **masks).numpy()


@pytest.mark.parametrize("kind", list(KINDS))
def test_splits_walk_every_visible_row_exactly_once(kind):
    lengths = _edge_lengths(kind)
    visible = _visible(kind, lengths)
    for b, length in enumerate(lengths):
        walked = _walked(kind, length)
        count = np.sum(walked, axis=0)
        assert count.max(initial=0) <= 1, f"{kind}, length {length}: a row walked by two splits"
        assert not (visible[b] & (count == 0)).any(), f"{kind}, length {length}: a visible row no split walks"


def test_split_mirror_has_empty_upper_splits_for_short_sequences():
    runs = tdecode.decode_split_runs(70, 5, rows=2048)
    assert [len(r) for r in runs] == [1, 1, 0, 0, 0]
    assert tdecode.decode_split_runs(0, 3, rows=2048) == [[], [], []]


# ---------------------------------------------------------------- the merge


def _partial(q, k, v, keep, sm_scale, *, raw=False):
    """fp32 attention of q [B, Hq, D] over the rows ``keep`` [B, S] admits:
    (o [B, Hq, D], base-2 LSE [B, Hq]), 0 and -inf where it admits none;
    with ``raw``, (o, its running max m, its sum of p l) instead."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d)
    s2 = torch.einsum("bhgd,bhsd->bhgs", qg, k) * (sm_scale * LOG2E)
    s2 = torch.where(keep[:, None, None, :], s2, MASK_VALUE)
    m = s2.amax(-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp2(s2 - m)
    l = p.sum(-1, keepdim=True)
    o = torch.where(l == 0, 0.0, torch.einsum("bhgs,bhsd->bhgd", p, v) / l)
    lse = torch.where(l == 0, -torch.inf, m + torch.log2(l))
    if raw:
        return o.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)
    return o.reshape(b, hq, d), lse.reshape(b, hq)


def _split_merged(kind, q, k, v, lengths):
    visible = torch.from_numpy(_visible(kind, lengths))
    parts = [[] for _ in range(SPLITS)]
    for length in lengths:
        for s, walked in enumerate(_walked(kind, length)):
            parts[s].append(torch.from_numpy(walked))
    outs = [_partial(q, k, v, visible & torch.stack(p), D**-0.5) for p in parts]
    return merge_partial_attention(torch.stack([o for o, _ in outs], 1), torch.stack([l for _, l in outs], 1), axis=1)


def _diff(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(got)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


@pytest.mark.parametrize("kind", ["window", "ring", "ring + sinks"])
def test_split_merge_equals_plain_and_jax(kind):
    rows, _, masks = KINDS[kind]
    lengths = [length for length in _edge_lengths(kind) if length <= (3 * rows if "ring" in kind else rows)]
    rng = np.random.default_rng(len(kind))
    q = rng.uniform(-1, 1, (len(lengths), 4, D)).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (len(lengths), 2, rows, D)).astype(np.float32) for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _split_merged(kind, tq, tk, tv, lengths)
    want, want_lse = tdecode.decode_attention_plain(tq, tk, tv, torch.tensor(lengths), sm_scale=D**-0.5,
                                                    save_residuals=True, **masks)
    assert _diff(out, want) <= TOL and _diff(lse, want_lse) <= TOL
    empty = np.asarray(lengths) == 0
    assert bool((out[empty] == 0).all()) and bool(torch.isneginf(lse[empty]).all())
    # JAX's kernel in interpret mode on eight of the lengths (it walks the
    # grid in Python): the shortest live ones and the longest.
    pick = [i for i, n in enumerate(lengths) if n][:4] + list(range(len(lengths)))[-4:]
    j_out, j_lse = jdecode.decode_attention(jnp.asarray(q[pick]), jnp.asarray(k[pick]), jnp.asarray(v[pick]),
                                            jnp.asarray([lengths[i] for i in pick], jnp.int32), save_residuals=True,
                                            **masks)
    assert _diff(out[pick], j_out) <= TOL and _diff(lse[pick], j_lse) <= TOL


def test_split_merge_equals_jax_decode_attention_split():
    """No mask: the kernel's cut (64-row runs, 4 splits) against JAX's
    host-side split into 4 equal pieces of the cache, both merged."""
    rows = 512
    lengths = [1, 63, 64, 65, 200, 257, 511, 512]
    rng = np.random.default_rng(9)
    q = rng.uniform(-1, 1, (len(lengths), 4, D)).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (len(lengths), 2, rows, D)).astype(np.float32) for _ in range(2))
    out, _ = _split_merged("none", *map(torch.from_numpy, (q, k, v)), lengths)
    want = jdecode.decode_attention_split(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lengths, jnp.int32), num_splits=4)
    assert _diff(out, want) <= TOL


def test_merge_without_the_max_rescale_is_caught():
    """The tolerance sees the fault a mutant of the kernel's merge makes:
    parts summed by l alone, without 2^(m_s - m)."""
    rows, _, masks = KINDS["window"]
    lengths = [900, 1100]
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.uniform(-1, 1, (2, 4, D)).astype(np.float32) * 4)
    k, v = (torch.from_numpy(rng.uniform(-1, 1, (2, 2, rows, D)).astype(np.float32)) for _ in range(2))
    want = tdecode.decode_attention_plain(q, k, v, torch.tensor(lengths), sm_scale=D**-0.5, **masks)
    visible = torch.from_numpy(_visible("window", lengths))
    walked = [torch.stack([torch.from_numpy(w[s]) for w in (_walked("window", n) for n in lengths)])
              for s in range(SPLITS)]
    parts = [_partial(q, k, v, visible & w, D**-0.5, raw=True) for w in walked]
    m = torch.stack([m for _, m, _ in parts]).amax(0)
    good = sum(o * (l * torch.exp2(ms - m))[..., None] for o, ms, l in parts) / sum(
        l * torch.exp2(ms - m) for _, ms, l in parts)[..., None]
    bad = sum(o * l[..., None] for o, _, l in parts) / sum(l for _, _, l in parts)[..., None]
    assert _diff(good, want) <= TOL and _diff(bad, want) > 1e-3


# ---------------------------------------------------------------- the page write


def _write_caches(num_slots=4, pages_per_slot=3, page=128, heads=2):
    rng = np.random.default_rng(5)
    num_pages = 1 + num_slots * pages_per_slot
    k, v = (rng.uniform(-1, 1, (num_pages, heads, page, D)).astype(np.float32) for _ in range(2))
    table = rng.permutation(np.arange(1, num_pages)).reshape(num_slots, pages_per_slot).astype(np.int32)
    table[0] = 0  # a released slot: its table on dump page 0
    lengths = np.array([37, pages_per_slot * page, 5, 128], np.int32)  # slot 1 at capacity
    j = jpaged.PagedKVCache(*(jnp.asarray(x) for x in (k, v, table, lengths)))
    t = tpaged.PagedKVCache(*(torch.from_numpy(x.copy()) for x in (k, v, table, lengths)))
    return j, t, rng


@pytest.mark.parametrize("slots_dtype", [np.int32, np.int64])
def test_paged_write_tokens_lengths_match_jax(slots_dtype):
    j, t, rng = _write_caches()
    slots = np.array([1, 3, 0, 2], slots_dtype)
    k_new, v_new = (rng.uniform(-1, 1, (4, 2, D)).astype(np.float32) for _ in range(2))
    before = tpaged.paged_write_tokens_multi.launches, tpaged.paged_write_tokens_multi.quant_launches
    want = jpaged.paged_write_tokens(j, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots, jnp.int32))
    got = tpaged.paged_write_tokens(t, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(slots))
    assert got.lengths.tolist() == np.asarray(want.lengths).tolist() == [38, 3 * 128, 6, 129]
    assert np.array_equal(got.k_pages.numpy(), np.asarray(want.k_pages))
    assert np.array_equal(got.v_pages.numpy(), np.asarray(want.v_pages))
    assert t.lengths.tolist() == [37, 3 * 128, 5, 128]  # replaced, not mutated
    assert (tpaged.paged_write_tokens_multi.launches, tpaged.paged_write_tokens_multi.quant_launches) == before


def test_paged_write_tokens_multi_lengths_match_jax():
    num_layers = 2
    j, t, rng = _write_caches()
    pools = [np.stack([np.asarray(x)] * num_layers) for x in (j.k_pages, j.v_pages)]
    cache = tpaged.PagedModelCache(torch.from_numpy(pools[0].copy()), torch.from_numpy(pools[1].copy()),
                                   t.page_table, t.lengths)
    j_layers = [jpaged.PagedKVCache(jnp.asarray(pools[0][i]), jnp.asarray(pools[1][i]), j.page_table, j.lengths)
                for i in range(num_layers)]
    slots = np.array([0, 1, 2, 3], np.int64)
    k_new, v_new = (rng.uniform(-1, 1, (num_layers, 4, 2, D)).astype(np.float32) for _ in range(2))
    before = tpaged.paged_write_tokens_multi.launches
    want = jpaged.paged_write_tokens_multi(j_layers, list(map(jnp.asarray, k_new)), list(map(jnp.asarray, v_new)),
                                           jnp.asarray(slots, jnp.int32))
    got = tpaged.paged_write_tokens_multi(cache, torch.from_numpy(k_new), torch.from_numpy(v_new),
                                          torch.from_numpy(slots))
    assert got.lengths.tolist() == np.asarray(want[0].lengths).tolist() == [38, 3 * 128, 6, 129]
    for layer, jc in zip(got.layers(), want):
        assert np.array_equal(layer.k_pages.numpy(), np.asarray(jc.k_pages))
        assert np.array_equal(layer.v_pages.numpy(), np.asarray(jc.v_pages))
    assert tpaged.paged_write_tokens_multi.launches == before
