"""Parity of the PyTorch port's paged serving engine with the JAX package's.

The port's PagedServingEngine (plain kernel versions on the CPU) must give
the same greedy tokens as the JAX PagedServingEngine (Pallas kernels in
interpret mode) on the same parameters, and as the port's own dense
engine: paging changes the memory layout, not the numbers. The config and
requests are tests/test_paged_engine.py's; fp32 weights keep argmax ties
deterministic, so tokens are compared exactly.
"""

import dataclasses

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

CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
REQS = [  # 5 requests for 3 slots
    ((5, 9, 2), 6),
    ((100, 3, 44, 8, 21, 60, 7), 9),
    ((64,), 4),
    ((11, 12, 13, 14), 5),
    ((90, 2), 3),
]
POOL = dict(max_slots=3, num_pages=16, pages_per_slot=2, page_size=128)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig(**CFG), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod, reqs=REQS, first_id=0):
    return [mod.Request(id=first_id + i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(reqs)]


def _tokens(out):
    return {i: (c.tokens, c.finished_by_eos) for i, c in out.items()}


def _serve(model, reqs=REQS, **kw):
    _, _, tcfg, tparams = model
    eng = torch_paged.PagedServingEngine(tparams, tcfg, **{**POOL, **kw})
    return eng, _tokens(eng.run(_requests(torch_engine, reqs)))


@pytest.fixture(scope="module")
def jax_tokens(model):
    jcfg, jparams, _, _ = model
    eng = jax_paged.PagedServingEngine(jparams, jcfg, **POOL)
    return _tokens(eng.run(_requests(jax_engine)))


@pytest.mark.parametrize("kw", [{}, {"decode_block_steps": 4}, {"decode_block_steps": 1, "pipeline_decode": False}])
def test_paged_engine_matches_jax(model, jax_tokens, kw):
    eng, got = _serve(model, **kw)
    assert got == jax_tokens
    assert all(len(got[i][0]) == n for i, (_, n) in enumerate(REQS))
    assert eng.alloc.free_count == 15  # every page back; page 0 is the dump page
    assert eng.sched.stats().completed == len(REQS) and eng._pending_block is None
    assert bool((eng.caches.page_table == 0).all())  # released slots point at the dump page


def test_paged_engine_matches_port_dense_engine(model):
    _, _, tcfg, tparams = model
    dense = torch_engine.ServingEngine(tparams, tcfg, max_slots=3, max_seq=256)
    _, got = _serve(model)
    assert got == _tokens(dense.run(_requests(torch_engine)))


def test_block_steps_one_equals_default(model):
    one, want = _serve(model, decode_block_steps=1)
    blocked, got = _serve(model)
    assert got == want
    dispatches = lambda e: sum(1 for ev in e.events if ev[0] == "decode")  # noqa: E731
    assert dispatches(blocked) < dispatches(one)


def _prefix_requests(mod):
    rng = np.random.RandomState(23)
    prefix = tuple(int(t) for t in rng.randint(0, 128, size=256))  # 2 pages
    tails = [tuple(int(t) for t in rng.randint(0, 128, size=40)) for _ in range(2)]
    return [mod.Request(id=1 + i, prompt=prefix + tail, max_new_tokens=8) for i, tail in enumerate(tails)]


PREFIX_POOL = dict(max_slots=2, num_pages=16, pages_per_slot=4, page_size=128, prefill_chunk=128)


def test_prefix_cache_matches_jax(model):
    """Request A registers its two full prompt pages; request B shares them,
    skips their two chunks, and both give JAX's tokens; the keys are JAX's."""
    jcfg, jparams, tcfg, tparams = model
    j_eng = jax_paged.PagedServingEngine(jparams, jcfg, **PREFIX_POOL, prefix_cache=True)
    t_eng = torch_paged.PagedServingEngine(tparams, tcfg, **PREFIX_POOL, prefix_cache=True)
    j_reqs, t_reqs = _prefix_requests(jax_engine), _prefix_requests(torch_engine)
    for j_req, t_req in zip(j_reqs, t_reqs):
        assert _tokens(t_eng.run([t_req])) == _tokens(j_eng.run([j_req]))
    assert t_eng.prefix_hits == j_eng.prefix_hits == 2
    assert list(t_eng._prefix) == list(j_eng._prefix)
    # A runs the 3 chunks of its 296-token prompt; B only its last one.
    assert sum(1 for e in t_eng.events if e[0] == "chunk") == 3 + 1


def test_prefix_cache_tokens_equal_no_cache_and_evict(model):
    """Zero-ref shared pages stay cached (pool short by 2), evict on demand
    restoring the pool, and the prefix then recomputes to the same tokens."""
    _, _, tcfg, tparams = model
    plain = torch_paged.PagedServingEngine(tparams, tcfg, **PREFIX_POOL)
    eng = torch_paged.PagedServingEngine(tparams, tcfg, **PREFIX_POOL, prefix_cache=True)
    reqs = _prefix_requests(torch_engine)
    want = [_tokens(plain.run([r])) for r in reqs]
    assert [_tokens(eng.run([r])) for r in reqs] == want
    assert eng.alloc.free_count == 15 - 2
    assert eng._evict_prefix_pages() and eng.alloc.free_count == 15 and not eng._prefix
    assert _tokens(eng.run([reqs[1]])) == want[1]


def test_pool_backpressure_defers_then_serves(model):
    """3 allocatable pages for 4 one-page requests on 4 slots: the 4th
    admission waits for a page, then completes with the dense tokens."""
    _, _, tcfg, tparams = model
    reqs = [((3 * i + 1, 2), 3) for i in range(4)]
    eng, got = _serve(model, reqs, max_slots=4, num_pages=4)
    dense = torch_engine.ServingEngine(tparams, tcfg, max_slots=4, max_seq=256)
    assert got == _tokens(dense.run(_requests(torch_engine, reqs)))
    assert eng.alloc.free_count == 3


def test_pool_too_small_raises(model):
    with pytest.raises(RuntimeError, match="page pool too small"):
        _serve(model, [(tuple(range(120)), 20)], max_slots=1, num_pages=2)


def test_second_run_on_one_engine(model):
    """Pages, tables and sampling state left by one run do not leak into the
    next: recycled pages give the same tokens as a fresh engine."""
    eng, first = _serve(model, REQS[:2])
    again = _tokens(eng.run(_requests(torch_engine)))
    _, fresh = _serve(model)
    assert again == fresh and first == {i: fresh[i] for i in first}
    assert eng.alloc.free_count == 15


@pytest.mark.parametrize("block_steps", [1, 8])
def test_eos_mid_block_matches_jax(model, block_steps):
    jcfg, jparams, tcfg, tparams = model
    _, free = _serve(model, [((5, 9, 2), 12)], max_slots=1, num_pages=8)
    toks = free[0][0]
    eos = toks[next(i for i in range(2, len(toks) - 1) if toks[i] not in toks[:i])]
    kw = dict(max_slots=1, num_pages=8, pages_per_slot=2, page_size=128, eos_id=eos, decode_block_steps=block_steps)
    req = [((5, 9, 2), 12)]
    j_eng = jax_paged.PagedServingEngine(jparams, jcfg, **kw)
    t_eng = torch_paged.PagedServingEngine(tparams, tcfg, **kw)
    got = _tokens(t_eng.run(_requests(torch_engine, req)))
    assert got == _tokens(j_eng.run(_requests(jax_engine, req)))
    assert got[0][1] and got[0][0][-1] == eos and t_eng.alloc.free_count == 7


def test_first_token_eos_releases_pages(model):
    """A request that ends at its first token (EOS from the prefill) releases
    its pages through the loop's _on_slot_finished hook."""
    _, free = _serve(model, [((5, 9, 2), 4)], max_slots=1, num_pages=8)
    eng, got = _serve(model, [((5, 9, 2), 4)], max_slots=1, num_pages=8, eos_id=free[0][0][0])
    assert got[0] == ([free[0][0][0]], True) and eng.alloc.free_count == 7


@pytest.mark.parametrize(
    "field, value, kw",
    [
        ("rolling", True, {}),
        ("sliding_window", 64, {}),
        ("attention_sinks", 4, {}),
        (None, None, {"shard_caches": lambda caches: caches}),
    ],
)
def test_unported_options_raise(model, field, value, kw):
    """The JAX engine's options on the port's. ``shard_caches`` without a
    mesh is a placement, as in JAX: the model unsharded and the tokens the
    unsharded engine's; a callable that reshapes the pools is no placement
    and raises (the tensor-parallel callable:
    tests/test_torch_sharded_serving.py). ``rolling`` is the dense cache's
    layout and leaves the paged engine as it is, a window builds the paged
    ring, and sinks without a window are refused as in the JAX engine."""
    _, _, tcfg, tparams = model
    if field is not None:
        tcfg = dataclasses.replace(tcfg, **{field: value})
    if field is None:
        assert _serve(model, **kw)[1] == _serve(model)[1]
        with pytest.raises(ValueError, match="placement only"):
            torch_paged.PagedServingEngine(tparams, tcfg, **POOL,
                                           shard_caches=lambda c: c._replace(k_pool=c.k_pool[:, :8]))
    elif field == "attention_sinks":
        with pytest.raises(ValueError, match="requires sliding_window"):
            torch_paged.PagedServingEngine(tparams, tcfg, **POOL, **kw)
    else:
        eng = torch_paged.PagedServingEngine(tparams, tcfg, **POOL, **kw)
        assert eng._admit_one(torch_engine.Request(id=0, prompt=(1, 2, 3), max_new_tokens=200), 0)
        assert len(eng.slot_pages[0]) == 2  # 203 rows: two logical pages, fewer than the ring's 5
        eng._release(0)
        assert eng.alloc.free_count == 15


def test_eviction_under_pressure_keeps_the_matched_prefix(model):
    """Admission under pool pressure evicts zero-ref prefix pages, but never
    the ones the admitted request has just matched: B shares A's two prefix
    pages while C's stale page is evicted to make room, and B's tokens equal
    those of an engine without the cache."""
    _, _, tcfg, tparams = model
    pool = dict(max_slots=1, num_pages=5, pages_per_slot=4, page_size=128, prefill_chunk=128)
    rng = np.random.RandomState(5)
    prefix = tuple(int(t) for t in rng.randint(0, 128, size=256))
    req_c = ((tuple(int(t) for t in rng.randint(0, 128, size=130))), 4)  # 2 pages, registers 1
    req_a = (prefix + tuple(int(t) for t in rng.randint(0, 128, size=40)), 80)  # 3 pages, registers 2
    req_b = (prefix + tuple(int(t) for t in rng.randint(0, 128, size=40)), 100)  # shares 2, needs 2 more
    eng = torch_paged.PagedServingEngine(tparams, tcfg, **pool, prefix_cache=True)
    for r in (req_c, req_a):
        eng.run(_requests(torch_engine, [r]))
    assert eng.alloc.free_count == 1 and len(eng._prefix) == 3
    got = _tokens(eng.run(_requests(torch_engine, [req_b])))
    _, want = _serve(model, [req_b], **pool)
    assert got == want and eng.prefix_hits == 2
    assert len(eng._prefix) == 2 and eng.alloc.free_count == 2  # C's page went, A's two stay
