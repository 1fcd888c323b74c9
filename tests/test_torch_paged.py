"""Parity of the PyTorch port's paged KV ops and paged model steps with the
JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode, as tests/test_paged.py runs them) and
through the port's plain versions, which its wrappers take for CPU tensors.
Page tables are shuffled permutations of the pool, so reading pages in
order would fail, and slot 0's table points at dump page 0 as a released
slot's does.

Tolerances: fp32 ops 1e-4 and base-2 LSE 1e-4 (summation order only),
logits 1e-3; the page writes are copies and must be EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.ops import merge as jmerge
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.ops import merge as tmerge
from flash_attention_tpu_torch.ops import paged as tpaged

OP_TOL = 1e-4
LSE_TOL = 1e-4
LOGIT_TOL = 1e-3
PAGE = 128
HEAD_DIM = 32
CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)


def _diff(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), "non-finite entries differ"
    assert np.array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)])
    fin = np.isfinite(got)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def _uniform(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _tables(rng, num_slots, pages_per_slot, num_pages):
    """A shuffled table over pages 1..num_pages-1; slot 0 all dump page 0."""
    table = rng.permutation(np.arange(1, num_pages))[: num_slots * pages_per_slot]
    table = table.reshape(num_slots, pages_per_slot).astype(np.int32)
    table[0] = 0
    return table


def _both_caches(seed, *, num_slots, kv_heads, pages_per_slot, lengths, head_dim=HEAD_DIM):
    """The same filled paged cache as a JAX and a port PagedKVCache."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + num_slots * pages_per_slot
    k = _uniform(rng, (num_pages, kv_heads, PAGE, head_dim))
    v = _uniform(rng, (num_pages, kv_heads, PAGE, head_dim))
    table = _tables(rng, num_slots, pages_per_slot, num_pages)
    lengths = np.asarray(lengths, np.int32)
    j = jpaged.PagedKVCache(*(jnp.asarray(x) for x in (k, v, table, lengths)))
    t = tpaged.PagedKVCache(*(torch.from_numpy(x.copy()) for x in (k, v, table, lengths)))
    return j, t


def _assert_caches_equal(tc, jc):
    for name in ("k_pages", "v_pages", "page_table", "lengths"):
        assert np.array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name))), name


# ---------------------------------------------------------------- merge


def _parts_with_empty_rows(seed, shape):
    rng = np.random.default_rng(seed)
    lse = rng.normal(size=shape).astype(np.float32) * 4
    lse[0, ..., 0] = -np.inf  # one part empty
    lse[..., 1] = -np.inf  # every part empty
    return lse


def test_merge_two_matches_jax():
    rng = np.random.default_rng(0)
    o_a, o_b = _uniform(rng, (3, 4, 32)), _uniform(rng, (3, 4, 32))
    lse = _parts_with_empty_rows(1, (2, 3, 4))
    lse[1, 2, 2] = -np.inf  # the other part empty
    want_o, want_lse = jmerge.merge_two(*map(jnp.asarray, (o_a, lse[0], o_b, lse[1])))
    got_o, got_lse = tmerge.merge_two(*map(torch.from_numpy, (o_a, lse[0], o_b, lse[1])))
    assert _diff(got_o, want_o) <= OP_TOL and _diff(got_lse, want_lse) <= LSE_TOL
    assert bool((got_o[:, 1] == 0).all()) and bool(torch.isneginf(got_lse[:, 1]).all())
    assert torch.allclose(got_o[2, 2], torch.from_numpy(o_a[2, 2]))  # only part a


@pytest.mark.parametrize("axis", [1, -3])
def test_merge_partial_attention_matches_jax(axis):
    rng = np.random.default_rng(2)
    o_parts = _uniform(rng, (2, 3, 4, 32))  # [B, parts, q, d]
    lse = np.moveaxis(_parts_with_empty_rows(3, (3, 2, 4)), 0, 1)  # [B, parts, q]
    want_o, want_lse = jmerge.merge_partial_attention(jnp.asarray(o_parts), jnp.asarray(lse), axis=axis)
    got_o, got_lse = tmerge.merge_partial_attention(torch.from_numpy(o_parts), torch.from_numpy(lse), axis=axis)
    assert got_o.shape == (2, 4, 32) and got_lse.shape == (2, 4)
    assert _diff(got_o, want_o) <= OP_TOL and _diff(got_lse, want_lse) <= LSE_TOL


def test_merge_partial_attention_rejects_bad_axis():
    o, lse = torch.zeros((2, 3, 4, 8)), torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="axis"):
        tmerge.merge_partial_attention(o, lse, axis=3)
    with pytest.raises(ValueError, match="shape"):
        tmerge.merge_partial_attention(o, lse[:, :2], axis=1)


# ---------------------------------------------------------------- kernels' functions


@pytest.mark.parametrize("group", [1, 4])
def test_paged_decode_attention_matches_jax(group):
    """K7's function: output and base-2 LSE, lengths 0 (the dump slot), 1,
    ragged and full."""
    kv_heads, pages_per_slot = 2, 4
    lengths = [0, 1, 200, pages_per_slot * PAGE]
    jc, tc = _both_caches(4, num_slots=4, kv_heads=kv_heads, pages_per_slot=pages_per_slot, lengths=lengths)
    q = _uniform(np.random.default_rng(5), (4, kv_heads * group, HEAD_DIM))
    want_o, want_lse = jpaged.paged_decode_attention(jnp.asarray(q), jc, save_residuals=True)
    got_o, got_lse = tpaged.paged_decode_attention(torch.from_numpy(q), tc, save_residuals=True)
    assert got_o.shape == q.shape and got_lse.shape == (4, kv_heads * group) and got_lse.dtype == torch.float32
    assert _diff(got_o, want_o) <= OP_TOL and _diff(got_lse, want_lse) <= LSE_TOL
    assert bool((got_o[0] == 0).all()) and bool(torch.isneginf(got_lse[0]).all())


@pytest.mark.parametrize("kv_end", [256, 512])
def test_paged_prefill_attention_matches_jax(kv_end):
    """K8's function: a 256-row chunk at [kv_end - 256, kv_end) over the
    slot's shuffled pages."""
    jc, tc = _both_caches(6, num_slots=2, kv_heads=2, pages_per_slot=4, lengths=[0, kv_end])
    q = _uniform(np.random.default_rng(7), (1, 8, 256, HEAD_DIM))
    want = jpaged.paged_prefill_attention(jnp.asarray(q), jc, 1, kv_end, chunk_len=256)
    got = tpaged.paged_prefill_attention(torch.from_numpy(q), tc, 1, kv_end, chunk_len=256)
    assert got.shape == q.shape and _diff(got, want) <= OP_TOL


@pytest.mark.parametrize("kv_end, match", [(128, "must not be negative"), (640, "exceeds slot capacity")])
def test_paged_prefill_attention_checks_kv_end(kv_end, match):
    _, tc = _both_caches(6, num_slots=2, kv_heads=2, pages_per_slot=4, lengths=[0, 0])
    with pytest.raises(ValueError, match=match):
        tpaged.paged_prefill_attention(torch.zeros((1, 8, 256, HEAD_DIM)), tc, 1, kv_end, chunk_len=256)


def test_paged_gather_kv_matches_jax():
    jc, tc = _both_caches(8, num_slots=3, kv_heads=2, pages_per_slot=3, lengths=[0, 0, 0])
    want_k, want_v = jpaged.paged_gather_kv(jc, 2, 256)
    got_k, got_v = tpaged.paged_gather_kv(tc, 2, 256)
    assert got_k.shape == (1, 2, 256, HEAD_DIM)
    assert np.array_equal(got_k.numpy(), np.asarray(want_k)) and np.array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------- page writes


def test_paged_write_prefill_matches_jax():
    """Two pages of rows at logical [128, 384) of slot 1, one index
    assignment per K and V."""
    jc, tc = _both_caches(9, num_slots=3, kv_heads=2, pages_per_slot=4, lengths=[0, 0, 0])
    rng = np.random.default_rng(10)
    k_new, v_new = _uniform(rng, (2, 256, HEAD_DIM)), _uniform(rng, (2, 256, HEAD_DIM))
    want = jpaged.paged_write_prefill(jc, jnp.asarray(k_new), jnp.asarray(v_new), 1, 300, start=128)
    got = tpaged.paged_write_prefill(tc, torch.from_numpy(k_new), torch.from_numpy(v_new), 1, 300, start=128)
    _assert_caches_equal(got, want)
    assert got.lengths.tolist() == [0, 300, 0]


def test_paged_write_tokens_matches_jax():
    """K9's function: rows at a page boundary (127 -> page 0's last row,
    128 -> page 1's first), a slot at capacity (writes nothing, length
    stays) and the dump slot, for a subset of slots in shuffled order."""
    lengths = [5, 127, 128, 4 * PAGE]
    jc, tc = _both_caches(11, num_slots=4, kv_heads=2, pages_per_slot=4, lengths=lengths)
    rng = np.random.default_rng(12)
    slots = np.array([3, 0, 2, 1], np.int32)
    k_new, v_new = _uniform(rng, (4, 2, HEAD_DIM)), _uniform(rng, (4, 2, HEAD_DIM))
    want = jpaged.paged_write_tokens(jc, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots))
    got = tpaged.paged_write_tokens(tc, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(slots))
    _assert_caches_equal(got, want)
    assert got.lengths.tolist() == [6, 128, 129, 4 * PAGE]


def test_paged_write_tokens_multi_matches_jax():
    """K10's function over the 3 layers of one model cache (one pool per K
    and V, one table, one lengths tensor): the lengths advance once."""
    num_layers, lengths = 3, [5, 127, 4 * PAGE, 300]
    rng = np.random.default_rng(13)
    num_pages = 1 + 4 * 4
    table = _tables(rng, 4, 4, num_pages)
    k = _uniform(rng, (num_layers, num_pages, 2, PAGE, HEAD_DIM))
    v = _uniform(rng, (num_layers, num_pages, 2, PAGE, HEAD_DIM))
    k_new, v_new = _uniform(rng, (num_layers, 4, 2, HEAD_DIM)), _uniform(rng, (num_layers, 4, 2, HEAD_DIM))
    j_caches = [
        jpaged.PagedKVCache(jnp.asarray(k[i]), jnp.asarray(v[i]), jnp.asarray(table), jnp.asarray(lengths, jnp.int32))
        for i in range(num_layers)
    ]
    t_cache = tpaged.init_paged_model_cache(
        num_layers, num_pages=num_pages, num_slots=4, pages_per_slot=4, kv_heads=2,
        page_size=PAGE, head_dim=HEAD_DIM, dtype=torch.float32, device="cpu",
    )
    t_cache.k_pool.copy_(torch.from_numpy(k))
    t_cache.v_pool.copy_(torch.from_numpy(v))
    t_cache.page_table.copy_(torch.from_numpy(table))
    t_cache.lengths.copy_(torch.tensor(lengths))
    slots = np.arange(4, dtype=np.int32)
    want = jpaged.paged_write_tokens_multi(j_caches, list(map(jnp.asarray, k_new)), list(map(jnp.asarray, v_new)), jnp.asarray(slots))
    got = tpaged.paged_write_tokens_multi(t_cache, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(slots))
    for tc, jc in zip(got.layers(), want):
        _assert_caches_equal(tc, jc)
    assert got.page_table is t_cache.page_table and got.lengths.tolist() == [6, 128, 4 * PAGE, 301]
    assert t_cache.lengths.tolist() == lengths  # replaced, not mutated


def test_init_paged_model_cache_layers_share_table_lengths_and_pool():
    cache = tpaged.init_paged_model_cache(
        4, num_pages=5, num_slots=2, pages_per_slot=2, kv_heads=2, page_size=PAGE,
        head_dim=HEAD_DIM, dtype=torch.bfloat16, device="cpu",
    )
    layers = cache.layers()
    want = jpaged.init_paged_cache(num_pages=5, num_slots=2, pages_per_slot=2, kv_heads=2, page_size=PAGE, head_dim=HEAD_DIM)
    assert len(layers) == 4 and tuple(layers[0].k_pages.shape) == want.k_pages.shape
    assert layers[0].k_pages.dtype == torch.bfloat16
    assert tuple(cache.page_table.shape) == want.page_table.shape and cache.page_table.dtype == torch.int32
    assert all(c.page_table is cache.page_table and c.lengths is cache.lengths for c in layers)
    assert layers[3].v_pages.data_ptr() == cache.v_pool[3].data_ptr()
    assert not cache.quantized() and layers[0].k_scales is None
    # A quantized cache: int8 payload zeroed, scales of one in JAX's memory
    # order without its size-1 lane axis, and per-layer views of both.
    quant = tpaged.init_paged_model_cache(4, num_pages=5, num_slots=2, pages_per_slot=2, kv_heads=2,
                                          page_size=PAGE, head_dim=HEAD_DIM, kv_quant="int8", device="cpu")
    want = jpaged.init_paged_cache(num_pages=5, num_slots=2, pages_per_slot=2, kv_heads=2, page_size=PAGE,
                                   head_dim=HEAD_DIM, kv_quant="int8")
    layer = quant.layers()[3]
    assert layer.k_pages.dtype == torch.int8 and tuple(layer.k_pages.shape) == want.k_pages.shape
    assert np.array_equal(layer.v_scales.numpy(), np.asarray(want.v_scales).reshape(5, 2, PAGE))
    assert layer.k_scales.data_ptr() == quant.k_scales[3].data_ptr()


def test_wrappers_refuse_other_devices():
    """The wrappers take their plain version for CPU tensors only; any other
    device that is not CUDA is refused, not served by the plain version."""
    cache = tpaged.init_paged_cache(num_pages=3, num_slots=1, pages_per_slot=2, kv_heads=1, page_size=PAGE,
                                    head_dim=HEAD_DIM, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpaged.paged_decode_attention(torch.zeros((1, 1, HEAD_DIM), device="meta"), cache)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpaged.paged_write_tokens(cache, torch.zeros((1, 1, HEAD_DIM), device="meta"),
                                  torch.zeros((1, 1, HEAD_DIM), device="meta"), [0])


# ---------------------------------------------------------------- model steps


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jt.ModelConfig(**CFG), tt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _model_caches(jcfg, tcfg, table, page_size=PAGE):
    kw = dict(num_pages=7, num_slots=3, pages_per_slot=table.shape[1], page_size=page_size)
    j_caches = [c._replace(page_table=jnp.asarray(table)) for c in jt.init_paged_caches(jcfg, **kw)]
    t_cache = tt.init_paged_caches(tcfg, **kw, device="cpu")
    t_cache.page_table.copy_(torch.from_numpy(table))
    return j_caches, t_cache


def test_chunked_prefill_then_decode_paged_match_jax(model):
    """Two 128-token chunks into slot 1 (the second reads the first through
    the pages in place), then deferred decode steps for every slot."""
    jcfg, tcfg, jparams, tparams = model
    table = np.array([[0, 0], [4, 2], [5, 1]], np.int32)
    j_caches, t_cache = _model_caches(jcfg, tcfg, table)
    toks = np.random.default_rng(14).integers(0, 128, (1, 256)).astype(np.int32)
    for lo, hi in ((0, 128), (128, 256)):
        j_logits, j_caches = jt.prefill_chunk_paged(
            jparams, jcfg, jnp.asarray(toks[:, lo:hi]), j_caches, jnp.int32(1), jnp.int32(lo), hi
        )
        t_logits, t_cache = tt.prefill_chunk_paged(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), t_cache, 1, lo, hi)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
    for jc, tc in zip(j_caches, t_cache.layers()):
        assert _diff(tc.k_pages, jc.k_pages) <= OP_TOL and _diff(tc.v_pages, jc.v_pages) <= OP_TOL
    assert t_cache.lengths.tolist() == np.asarray(j_caches[0].lengths).tolist() == [0, 256, 0]
    j_caches = [c._replace(lengths=jnp.asarray([0, 250, 3], jnp.int32)) for c in j_caches]
    t_cache = t_cache._replace(lengths=torch.tensor([0, 250, 3], dtype=torch.int32))

    j_tok = jnp.asarray([[3], [5], [7]], jnp.int32)
    t_tok = torch.from_numpy(np.array(j_tok))
    for _ in range(2):
        j_logits, j_caches = jt.decode_step_logits_paged(jparams, jcfg, j_tok, j_caches)
        t_logits, t_cache = tt.decode_step_logits_paged(tparams, tcfg, t_tok, t_cache)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
        j_tok = jnp.argmax(j_logits, axis=-1)[:, None].astype(jnp.int32)
        t_tok = torch.argmax(t_logits, dim=-1)[:, None].to(torch.int32)
        assert t_tok.tolist() == np.asarray(j_tok).tolist()
    j_tok, j_caches = jt.decode_step_paged(jparams, jcfg, j_tok, j_caches)
    t_tok, t_cache = tt.decode_step_paged(tparams, tcfg, t_tok, t_cache)
    assert t_tok.tolist() == np.asarray(j_tok).tolist()
    assert t_cache.lengths.tolist() == np.asarray(j_caches[0].lengths).tolist() == [3, 253, 6]
    for jc, tc in zip(j_caches, t_cache.layers()):
        assert _diff(tc.k_pages, jc.k_pages) <= OP_TOL and _diff(tc.v_pages, jc.v_pages) <= OP_TOL


def test_chunked_prefill_small_pages_matches_jax(model):
    """64-row pages and 64-token chunks: the port runs them through K8's
    function like any chunk, where the JAX package gathers the visible pages
    densely (its Pallas grid needs 128-row chunks); the results agree."""
    jcfg, tcfg, jparams, tparams = model
    table = np.array([[0, 0, 0], [4, 6, 2], [5, 1, 3]], np.int32)
    j_caches, t_cache = _model_caches(jcfg, tcfg, table, page_size=64)
    toks = np.random.default_rng(18).integers(0, 128, (1, 192)).astype(np.int32)
    for lo, hi in ((0, 64), (64, 128), (128, 192)):
        j_logits, j_caches = jt.prefill_chunk_paged(
            jparams, jcfg, jnp.asarray(toks[:, lo:hi]), j_caches, jnp.int32(2), jnp.int32(lo), hi
        )
        t_logits, t_cache = tt.prefill_chunk_paged(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), t_cache, 2, lo, hi)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
    for jc, tc in zip(j_caches, t_cache.layers()):
        assert _diff(tc.k_pages, jc.k_pages) <= OP_TOL and _diff(tc.v_pages, jc.v_pages) <= OP_TOL
    assert t_cache.lengths.tolist() == [0, 0, 192]


def test_one_shot_prefill_paged_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    table = np.array([[0, 0], [3, 6], [1, 5]], np.int32)
    j_caches, t_cache = _model_caches(jcfg, tcfg, table)
    toks = np.random.default_rng(15).integers(0, 128, (1, 128)).astype(np.int32)
    j_logits, j_caches = jt.prefill_paged(jparams, jcfg, jnp.asarray(toks), j_caches, jnp.int32(2), 100)
    t_logits, t_cache = tt.prefill_paged(tparams, tcfg, torch.from_numpy(toks), t_cache, 2, 100)
    assert _diff(t_logits, j_logits) <= LOGIT_TOL
    for jc, tc in zip(j_caches, t_cache.layers()):
        assert _diff(tc.k_pages, jc.k_pages) <= OP_TOL
        assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [0, 0, 100]


def test_write_first_decode_matches_jax(model):
    """``attention_decode_paged``, the write-first path through K9, against
    the JAX package's, on one layer."""
    jcfg, tcfg, jparams, tparams = model
    jc, tc = _both_caches(16, num_slots=3, kv_heads=2, pages_per_slot=2, lengths=[0, 127, 40])
    x = _uniform(np.random.default_rng(17), (3, 1, 128))
    j_out, jc = jattn.attention_decode_paged(jparams["layers"][0]["attn"], jcfg.attention_config(), jnp.asarray(x), jc)
    t_out, tc = tattn.attention_decode_paged(tparams["layers"][0]["attn"], tcfg.attention_config(), torch.from_numpy(x), tc)
    assert _diff(t_out, j_out) <= OP_TOL
    assert _diff(tc.k_pages, jc.k_pages) <= OP_TOL and tc.lengths.tolist() == [1, 128, 41]
