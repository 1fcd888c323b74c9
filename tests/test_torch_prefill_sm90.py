"""K8 (paged prefill, with its dequant branch K8q) and K2 (a causal window
of at most 64) on the tensor-core body of csrc/flash_fwd_sm90.cu, on the
CPU.

The kernel runs only on the card (chip_smoke.py phases 6, 9 and 15 and
their sweeps hold it there); here the port's plain pieces stand for it:

  * the body a paged-prefill call takes, by query dtype and page payload,
    and the C entry's dispatch to the tensor-core body;
  * ``fwd_walk``, the plain mirror of the kernel's walk: for K8 with a
    window, sinks and the paged ring, and K2's window, at chunk lengths
    {1, 63, 64, 65, 100, 256}, kv_end at page edges +-1, pages of 64 and
    128 rows and q tiles of 64 and 128 rows, every visible pair lies in
    exactly one walked tile, no tile straddles a page, and every walked
    tile holds a visible pair (so no tile wholly below the band, where the
    ring's rolled-out pages alias live ones, is read);
  * K8's and K2's functions (the plain versions a CPU call takes) against
    the JAX package (its Pallas kernels in interpret mode) at the shapes
    JAX accepts, and at the other edges against an oracle on the gathered
    dense K / V (the JAX package's reference_attention, or with sinks an
    explicit numpy mask);
  * a bf16 call on the CPU launches nothing, and the sources name no JAX
    module.

Tolerance: fp32 at 1e-4, the same math summed in another order (outputs
are means of values in (-1, 1)).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu.ops.reference import reference_attention as jax_reference_attention
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax
from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops.common import visible_mask
from flash_attention_tpu_torch.ops.flash_attention import KV_TILE, flash_attention, fwd_body, fwd_walk

TOL = 1e-4
D = 32
CHUNKS = (1, 63, 64, 65, 100, 256)


def _diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


# ---------------------------------------------------------------- the route


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("payload", [None, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2])
def test_paged_prefill_body_by_query_dtype_and_payload(q_dtype, payload):
    """bf16 / fp16 queries take the tensor cores over any pages (a 1-byte
    payload widens exactly to the query's type for Q K and to bf16 for P
    V); fp32 queries keep the FMA body."""
    want = "fma" if q_dtype == torch.float32 else "tensor_core"
    assert fwd_body(q_dtype) == want, payload


def test_paged_prefill_entry_dispatches_half_precision_to_the_tensor_cores():
    """fat_paged_prefill hands bf16 / fp16 queries, with the table, the
    device slot, page size, sinks and the scales, to sm90_fwd; fp32 keeps
    flash_fwd.cu's own body. The tensor-core body finds the slot's table
    row from the slot in device memory and reads it into shared memory
    before any copy is issued."""
    src = (_build.CSRC_DIR / "flash_fwd.cu").read_text()
    paged = src[src.index('extern "C" int fat_paged_prefill'):]
    assert "dtype != fat::kFloat32" in paged and "fat::sm90_fwd(c)" in paged
    assert all(f"c.{f} =" in paged for f in ("table", "slot", "table_rows", "table_stride", "page_size", "num_pages",
                                             "sinks", "ks", "vs", "q_tile"))
    body = (_build.CSRC_DIR / "flash_fwd_sm90.cu").read_text()
    row = body.index("const int32_t* row = p.table + static_cast<int64_t>(min(max(*p.slot, 0)")
    fill, issue = body.index("s_table[i] = min(max(row[i], 0)"), body.index("load_kv(s, n_load);")
    assert row < fill < issue


# ---------------------------------------------------------------- the walk


def _covered_once(walk, need_cols):
    """Every needed column lies in exactly one walked tile."""
    counts = np.zeros(max([*need_cols, *[n + KV_TILE for n in walk], 1]) + KV_TILE, np.int32)
    for n0 in walk:
        counts[max(n0, 0):n0 + KV_TILE] += 1
    return all(counts[c] == 1 for c in need_cols)


def _check_walk(q_len, kv_len, q_tile, *, window=None, sinks=0, page=None):
    vis = visible_mask(q_len, kv_len, "cpu", causal=True, window=window, sinks=sinks)[0].numpy()
    for m0 in range(0, q_len, q_tile):
        walk = fwd_walk(m0, q_tile, q_len, kv_len, window=window, sinks=sinks)
        rows = vis[m0:m0 + q_tile]
        need = set(np.nonzero(rows.any(0))[0].tolist())
        what = f"q {q_len} kv {kv_len} tile {q_tile} m0 {m0} window {window} sinks {sinks} page {page}: {walk}"
        assert walk == sorted(set(walk)) and all(b - a >= KV_TILE for a, b in zip(walk, walk[1:])), what
        assert _covered_once(walk, need), what
        for n0 in walk:  # every walked tile holds a pair some row of the block sees
            assert rows[:, max(n0, 0):n0 + KV_TILE].any(), what
            assert n0 % KV_TILE == 0, what
            if page is not None:
                assert n0 // page == (n0 + KV_TILE - 1) // page, what


def _edges(page, pages=4):
    return sorted({e for p in range(1, pages + 1) for e in (p * page - 1, p * page, p * page + 1)})


@pytest.mark.parametrize("page", [64, 128])
@pytest.mark.parametrize("q_tile", [64, 128])
@pytest.mark.parametrize(
    "window,sinks", [(None, 0), (1, 0), (63, 3), (64, 0), (100, 3), (200, 5), (4096, 4)],
    ids=["causal", "w1", "w63+3", "w64", "w100+3", "w200+5", "w4096+4"],
)
def test_paged_walk_covers_every_visible_pair_once(page, q_tile, window, sinks):
    """K8's walk (aligned tiles: the sink tiles, then the band) over chunks
    at kv_end on every page edge +-1."""
    for chunk in CHUNKS:
        for kv_end in _edges(page):
            if kv_end >= chunk:
                _check_walk(chunk, kv_end, q_tile, window=window, sinks=sinks, page=page)


@pytest.mark.parametrize("q_tile", [64, 128])
@pytest.mark.parametrize("window", [1, 48, 63, 64])
def test_band_walk_covers_every_visible_pair_once(q_tile, window):
    """K2's walk (K1's: from the tile of the q tile's first visible column):
    a 64-row q tile walks at most three 64-row kv tiles, and two where
    kv_len - q_len is a multiple of 64."""
    for q_len in CHUNKS:
        for kv_len in sorted({q_len, q_len + 1, q_len + 63, 2 * q_len + 7, *_edges(64, 3)}):
            if kv_len >= q_len:
                _check_walk(q_len, kv_len, q_tile, window=window)
                walks = [fwd_walk(m0, 64, q_len, kv_len, window=window) for m0 in range(0, q_len, 64)]
                assert max(len(w) for w in walks) <= (2 if (kv_len - q_len) % 64 == 0 else 3)


def test_walk_without_sink_tiles_misses_the_sinks():
    """The mirror catches a walk that skips the sink tiles: the band alone
    leaves [0, sinks) unseen."""
    walk = fwd_walk(0, 64, 64, 1000, window=100)
    vis = visible_mask(64, 1000, "cpu", causal=True, window=100, sinks=4)[0].numpy()
    need = set(np.nonzero(vis.any(0))[0].tolist())
    assert not _covered_once(walk, need)
    assert _covered_once(fwd_walk(0, 64, 64, 1000, window=100, sinks=4), need)


# ---------------------------------------------------------------- K8's function


def _ring_caches(seed, *, sinks, page, kv_heads=2, n_ring=5, pages_per_slot=8, kv_quant="none"):
    """The same slot as a JAX PagedKVCache and the port's: slot 0 owns
    n_ring pages (one more pinned as logical page 0 with sinks), its logical
    pages mapped onto them modulo their count and shuffled over the pool,
    so rolled-out logical pages alias live ones."""
    rng = np.random.default_rng(seed)
    owned = n_ring + int(sinks)
    num_pages = 1 + 2 * owned
    perm = rng.permutation(np.arange(1, num_pages)).reshape(2, owned)
    table = np.zeros((2, pages_per_slot), np.int32)
    for b in range(2):
        if sinks:
            table[b] = [perm[b, 0]] + [perm[b, 1 + (lp - 1) % n_ring] for lp in range(1, pages_per_slot)]
        else:
            table[b] = [perm[b, lp % n_ring] for lp in range(pages_per_slot)]
    k, v = (rng.uniform(-1, 1, (num_pages, kv_heads, page, D)).astype(np.float32) for _ in range(2))
    lengths = np.asarray([pages_per_slot * page, 0], np.int32)
    if kv_quant == "none":
        j = jpaged.PagedKVCache(*(jnp.asarray(x) for x in (k, v, table, lengths)))
    else:
        payload = jquant.payload_dtype(kv_quant)
        kq, vq = (jquant.quantize_values(jnp.asarray(x), payload) for x in (k, v))
        scales = [jnp.swapaxes(x.scales, 2, 3) for x in (kq, vq)]  # the JAX pages' [P, H, 1, page]
        j = jpaged.PagedKVCache(kq.values, vq.values, jnp.asarray(table), jnp.asarray(lengths), *scales)
    return j, kv_cache_from_jax(j, device="cpu")


@pytest.mark.parametrize(
    "kv_end,window,sinks,kv_quant",
    [(255, None, 0, "none"), (257, 100, 3, "none"), (383, 64, 0, "fp8_e4m3"), (511, 200, 4, "int8")],
)
def test_paged_prefill_matches_jax_at_page_edges(kv_end, window, sinks, kv_quant):
    """A 128-row chunk (the JAX kernel's block) ending one row before or
    after a page edge, over the paged ring, with a window and sinks, and
    over quantized pages."""
    jc, tc = _ring_caches(11, sinks=bool(sinks), page=128, kv_quant=kv_quant)
    q = np.random.default_rng(12).uniform(-1, 1, (1, 4, 128, D)).astype(np.float32)
    kw = dict(sliding_window=window, attention_sinks=sinks)
    want = jpaged.paged_prefill_attention(jnp.asarray(q), jc, 0, kv_end, chunk_len=128, **kw)
    got = tpaged.paged_prefill_attention(torch.from_numpy(q), tc, 0, kv_end, chunk_len=128, **kw)
    assert _diff(got, want) <= TOL


def _dense_slot(cache, slot, kv_end):
    """The slot's first kv_end logical rows gathered from the pages here."""
    table = cache.page_table[slot].long()
    k, v = (x[table].permute(1, 0, 2, 3).reshape(x.shape[1], -1, D)[None, :, :kv_end] for x in
            (cache.k_pages, cache.v_pages))
    return k.numpy(), v.numpy()


def _oracle(q, k, v, *, window, sinks):
    """Causal attention, end-aligned, with the window and sinks as an
    explicit mask, in float64 numpy."""
    hq, t, hkv, kv_len = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    kf = np.repeat(k.astype(np.float64), hq // hkv, axis=1)
    vf = np.repeat(v.astype(np.float64), hq // hkv, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kf) / np.sqrt(D)
    row = np.arange(t)[:, None] + kv_len - t
    col = np.arange(kv_len)[None, :]
    ok = col <= row
    if window is not None:
        ok &= (col > row - window) | (col < sinks)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vf)


@pytest.mark.parametrize("page", [64, 128])
@pytest.mark.parametrize("window,sinks", [(None, 0), (64, 3), (150, 0)])
def test_paged_prefill_chunk_edges_match_the_oracle(page, window, sinks):
    """Chunks of {1, 63, 64, 65, 100, 256} rows ending at page edges +-1
    over the paged ring, against the oracle on the gathered dense K / V."""
    n_ring = 1024 // page if window is None else -(-(window + 256) // page) + 1  # a ring holding the band
    _, tc = _ring_caches(13, sinks=bool(sinks), page=page, pages_per_slot=1024 // page, n_ring=n_ring)
    rng = np.random.default_rng(14)
    for chunk in CHUNKS:
        for kv_end in (chunk + 1, 3 * page - 1, 3 * page, 3 * page + 1):
            if kv_end < chunk or kv_end > 1024:
                continue
            q = rng.uniform(-1, 1, (1, 4, chunk, D)).astype(np.float32)
            got = tpaged.paged_prefill_attention(torch.from_numpy(q), tc, 0, kv_end, chunk_len=chunk,
                                                 sliding_window=window, attention_sinks=sinks)
            k, v = _dense_slot(tc, 0, kv_end)
            want = _oracle(q, k, v, window=window, sinks=sinks)
            if window is not None and not sinks and chunk == 100:  # one JAX compile a shape: a few shapes
                jax_want = jax_reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                                   sliding_window=window)
                assert _diff(got, jax_want) <= TOL, (chunk, kv_end)
            assert _diff(got, want) <= TOL, (chunk, kv_end)


# ---------------------------------------------------------------- K2's function


@pytest.mark.parametrize("window", [1, 63, 64])
@pytest.mark.parametrize("q_len,kv_len", [(128, 128), (128, 384)])
def test_band_matches_jax(window, q_len, kv_len):
    """K2's function (a causal window of at most 64), output and base-2
    LSE, against the JAX package's band case in interpret mode."""
    rng = np.random.default_rng(window * 7 + kv_len)
    q, k, v = (rng.uniform(-1, 1, (1, 4, n, D)).astype(np.float32) for n in (q_len, kv_len, kv_len))
    k, v = k[:, :2], v[:, :2]
    kw = dict(causal=True, sliding_window=window, save_residuals=True)
    t_out, t_lse = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    j_out, j_lse = jax_flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert _diff(t_out, j_out) <= TOL and _diff(t_lse, j_lse) <= TOL


@pytest.mark.parametrize("q_len,kv_len", [(1, 1), (63, 63), (65, 130), (100, 100), (100, 229)])
def test_band_chunk_edges_match_the_reference(q_len, kv_len):
    """K2 at the chunk lengths off the tile edges against the JAX package's
    reference_attention."""
    rng = np.random.default_rng(q_len + kv_len)
    q = rng.uniform(-1, 1, (1, 4, q_len, D)).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (1, 2, kv_len, D)).astype(np.float32) for _ in range(2))
    for window in (1, 48, 64):
        got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sliding_window=window)
        want = jax_reference_attention(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=window)
        assert _diff(got, want) <= TOL, window


# ---------------------------------------------------------------- CPU calls and sources


def _counts():
    return ([getattr(tpaged.paged_prefill_attention, c) for c in
             ("launches", "quant_launches", "tensor_core_launches", "fma_launches")]
            + [getattr(flash_attention, c) for c in ("launches", "band_launches", "tensor_core_launches",
                                                     "fma_launches")])


@pytest.mark.parametrize("kv_quant", ["none", "fp8_e4m3"])
def test_cpu_bf16_calls_launch_nothing(kv_quant):
    """A bf16 K8 / K8q and K2 call on the CPU takes the plain version: no
    launch is counted, on either body."""
    _, tc = _ring_caches(15, sinks=True, page=64, kv_quant=kv_quant)
    if kv_quant == "none":
        tc = tc._replace(k_pages=tc.k_pages.to(torch.bfloat16), v_pages=tc.v_pages.to(torch.bfloat16))
    before = _counts()
    q = torch.randn(1, 4, 100, D).to(torch.bfloat16)
    out = tpaged.paged_prefill_attention(q, tc, 0, 300, chunk_len=100, sliding_window=64, attention_sinks=3)
    band = flash_attention(q, q[:, :2], q[:, :2], causal=True, sliding_window=64)
    assert out.dtype == band.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    assert _counts() == before


def test_prefill_sources_name_no_jax_module():
    """The sources of K8 / K8q / K2's body and its wrappers name no module
    or path of the JAX package (comments cite its files by path under ops/,
    never import them)."""
    named = re.compile(r"flash_attention_tpu(?=[/.])|#include\s*[<\"]jax|^\s*(import|from)\s+jax", re.M)
    for name in ("flash_fwd_sm90.cu", "flash_fwd_sm90.cuh", "flash_fwd.cu", "sm90_common.cuh", "common.cuh",
                 "decode.cu"):
        assert not named.search((_build.CSRC_DIR / name).read_text()), name
    pkg = _build.PKG_DIR / "ops"
    for name in ("paged.py", "flash_attention.py"):
        assert not named.search((pkg / name).read_text()), name
