"""The port's ``PagedServingEngine.warmup`` against the JAX package's.

On ``ModelConfig.tiny()`` (fp32) with the same weights on both sides
through ``params_from_jax``, pages of 16 rows, 4 pages a slot (max_seq
64), prefill chunks of one page and blocks of 8: after ``warmup()`` the
port's tokens equal a cold JAX paged engine's, the counters are zero, the
pool's free count, the prefix table and ``prefix_cache_enabled`` are as
they were, and the decode blocks walk every power-of-two length. A pool that can never hold the warmup
request raises as JAX's does, with the prefix cache restored.
"""

import copy

import jax
import numpy as np
import pytest

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu.serving import paged_engine as jax_paged
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving import paged_engine as torch_paged

TINY = dict(dtype="float32")
POOL = dict(max_slots=2, num_pages=12, pages_per_slot=4, page_size=16, prefill_chunk=16, decode_block_steps=8,
            prefix_cache=True)
FIRST = [(tuple(range(3, 23)), 5), ((5, 9, 2), 6)]  # the 20-token prompt registers one full page
THEN = [(tuple(range(3, 23)) + (40, 41), 7), ((100, 3, 44, 8, 21, 60, 7), 9), ((64,), 4)]


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig.tiny(**TINY)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig.tiny(**TINY), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod, reqs, first_id):
    return [mod.Request(id=first_id + i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(reqs)]


def _tokens(out):
    return {i: c.tokens for i, c in out.items()}


def _engine(model, **kw):
    _, _, tcfg, tparams = model
    return torch_paged.PagedServingEngine(tparams, tcfg, **{**POOL, **kw})


def test_warm_tokens_equal_a_cold_jax_engine_and_pool_is_restored(model):
    jcfg, jparams, _, _ = model
    cold = jax_paged.PagedServingEngine(jparams, jcfg, **POOL)
    want_first = _tokens(cold.run(_requests(jax_engine, FIRST, 0)))
    want_then = _tokens(cold.run(_requests(jax_engine, THEN, 10)))

    eng = _engine(model)
    assert _tokens(eng.run(_requests(torch_engine, FIRST, 0))) == want_first
    free, table, hits = eng.alloc.free_count, copy.deepcopy(eng._prefix), eng.prefix_hits
    assert len(table) == 1
    eng.warmup()
    assert (eng.steps, eng.decode_tokens, eng.decode_time_s, eng.events) == (0, 0, 0.0, [])
    assert eng.prefix_cache_enabled
    assert (eng.alloc.free_count, eng._prefix, eng.prefix_hits) == (free, table, hits)
    assert not eng.slot_pages
    assert _tokens(eng.run(_requests(torch_engine, THEN, 10))) == want_then
    assert eng.prefix_hits == hits + 1  # the shared page still serves the prefix


def test_warmup_without_prefix_cache_gives_back_every_page(model):
    eng = _engine(model, prefix_cache=False)
    free = eng.alloc.free_count
    eng.warmup(prompt_len=30)
    assert not eng.prefix_cache_enabled and eng.alloc.free_count == free == 11 and not eng._prefix


def test_warmup_walks_every_block_length(model):
    eng = _engine(model, max_slots=1)
    orig = eng._decode_multi
    seen = set()

    def spy(params, last, caches, active, t, k_, p, s, k, greedy=False):
        seen.add(k)
        return orig(params, last, caches, active, t, k_, p, s, k, greedy)

    eng._decode_multi = spy
    eng.warmup()
    assert seen == {8, 4, 2, 1}, seen


def test_pool_too_small_raises_as_jax_does(model):
    """3 pages, 2 of them allocatable, for a warmup request of 48 + 16 rows
    (4 pages): JAX's engine raises, and so does the port's; the prefix cache
    is switched back on either way."""
    jcfg, jparams, _, _ = model
    theirs = jax_paged.PagedServingEngine(jparams, jcfg, **{**POOL, "num_pages": 3})
    with pytest.raises(RuntimeError, match="page pool too small"):
        theirs.warmup()
    eng = _engine(model, num_pages=3)
    with pytest.raises(RuntimeError, match="page pool too small"):
        eng.warmup()
    assert eng.prefix_cache_enabled and theirs.prefix_cache_enabled


def test_max_seq_too_small_raises(model):
    with pytest.raises(ValueError, match=r"max_seq=16 leaves no room for a warmup prompt \(needs >= 17\)"):
        _engine(model, pages_per_slot=1).warmup()
