"""Parity of the PyTorch port's serving layer with the JAX package.

The port's ServingEngine (plain attention versions on the CPU) must give
the same greedy tokens as the JAX ServingEngine (Pallas kernels in interpret
mode) on the same parameters, with more requests than slots so slots get
refilled. fp32 weights keep argmax ties deterministic. Sampling masks are
compared exactly, and the Gumbel noise is equal to JAX's bits (see
serving/sampling.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from flash_attention_tpu.serving.scheduler import ContinuousBatchScheduler as JaxScheduler
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving.sampling import SamplingParams, gumbel_noise, sample_tokens
from flash_attention_tpu_torch.serving.scheduler import ContinuousBatchScheduler

CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
REQS = [  # 5 requests for 3 slots: two wait in the queue
    ((5, 9, 2), 6),
    ((100, 3, 44, 8, 21, 60, 7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13), 9),
    ((64,), 4),
    ((11, 12, 13, 14), 5),
    ((90, 2), 3),
]


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig(**CFG), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _serve(mod, cfg, params, reqs=REQS, **kw):
    eng = mod.ServingEngine(params, cfg, max_slots=3, max_seq=64, **kw)
    out = eng.run([mod.Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(reqs)])
    return eng, {i: (c.tokens, c.finished_by_eos) for i, c in out.items()}


@pytest.mark.parametrize(
    "kw",
    [
        {},  # defaults: one 64-token chunk per prompt, blocks of 16, pipelined
        {"prefill_chunk": 8, "decode_block_steps": 4},  # multi-chunk prompts
        {"prefill_chunk": 8, "decode_block_steps": 1, "pipeline_decode": False},
    ],
)
def test_engine_matches_jax(model, kw):
    jcfg, jparams, tcfg, tparams = model
    _, want = _serve(jax_engine, jcfg, jparams, **kw)
    eng, got = _serve(torch_engine, tcfg, tparams, **kw)
    assert got == want
    assert all(len(got[i][0]) == n for i, (_, n) in enumerate(REQS))
    st = eng.sched.stats()
    assert st.completed == len(REQS) and st.queued == 0 and st.decoding == 0
    assert eng._pending_block is None  # drained at exit


def test_eos_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    _, plain = _serve(jax_engine, jcfg, jparams)
    toks = plain[1][0]
    eos = next(t for i, t in enumerate(toks) if i >= 2 and t not in toks[:i])
    _, want = _serve(jax_engine, jcfg, jparams, eos_id=eos, decode_block_steps=4)
    _, got = _serve(torch_engine, tcfg, tparams, eos_id=eos, decode_block_steps=4)
    assert got == want
    assert got[1][1] and got[1][0][-1] == eos


def test_oversized_request_rejected(model):
    _, _, tcfg, tparams = model
    eng = torch_engine.ServingEngine(tparams, tcfg, max_slots=1, max_seq=32)
    got = eng.run([
        torch_engine.Request(id=1, prompt=tuple(range(30)), max_new_tokens=10),  # 40 > 32
        torch_engine.Request(id=2, prompt=(1, 2), max_new_tokens=2),
    ])
    assert got[1].tokens == [] and len(got[2].tokens) == 2


def test_engine_serves_a_second_batch_like_a_fresh_one(model):
    """Slots, caches and sampling state left by one run do not leak into
    the next (chip_smoke.py serves twice on one engine)."""
    _, _, tcfg, tparams = model
    used, first = _serve(torch_engine, tcfg, tparams, reqs=REQS[:2])
    again = used.run([torch_engine.Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(REQS)])
    _, fresh = _serve(torch_engine, tcfg, tparams)
    assert {i: (c.tokens, c.finished_by_eos) for i, c in again.items()} == fresh
    assert first == {i: fresh[i] for i in first}


def test_scheduler_matches_jax():
    """Both wrappers drive the same C++ state machine, built separately."""
    scheds = [ContinuousBatchScheduler(2, 16), JaxScheduler(2, 16)]

    def both(fn):
        a, b = (fn(s) for s in scheds)
        assert a == b
        return a

    assert both(lambda s: [s.submit(i, 3 + i, 4) for i in range(3)] + [s.submit(9, 15, 4)]) == [True] * 3 + [False]
    admitted = both(lambda s: s.admit())
    assert len(admitted) == 2
    for _, slot in admitted:
        both(lambda s: s.prefill_done(slot))
    both(lambda s: s.active_slots())
    both(lambda s: [s.record_token(admitted[0][1], False) for _ in range(4)])
    both(lambda s: (s.admit(), s.slot_request(admitted[0][1]), s.stats().__dict__))


def test_greedy_and_top_k_one_match_jax():
    """temperature 0 is argmax; top_k=1 (or a tiny top_p) keeps only the
    argmax, so even a sampled draw must return it — in both packages."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    temp = np.array([0, 0, 0.8, 1.5, 0.8, 0.8], np.float32)
    top_k = np.array([0, 5, 1, 1, 0, 0], np.int32)
    top_p = np.array([1, 1, 1, 1, 1e-6, 1], np.float32)
    seeds = np.arange(6, dtype=np.int32)
    pos = np.full(6, 11, np.int32)
    want = np.asarray(jax_sample_tokens(*map(jnp.asarray, (logits, temp, top_k, top_p, seeds, pos))))
    got = sample_tokens(*map(torch.from_numpy, (logits, temp, top_k, top_p, seeds, pos)))
    argmax = logits.argmax(-1)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[:5], want[:5])
    assert np.array_equal(got.numpy()[:5], argmax[:5])


def test_sampling_is_reproducible_and_truncated():
    noise = gumbel_noise(torch.tensor([3, 3, 4]), torch.tensor([7, 8, 7]), 64)
    again = gumbel_noise(torch.tensor([3]), torch.tensor([7]), 64)
    assert torch.equal(noise[0], again[0])
    # Reproducible across packages too: each row is JAX's draw, bit for bit.
    want = [np.asarray(jax.random.gumbel(jax.random.fold_in(jax.random.key(s), p), (64,), jnp.float32))
            for s, p in ((3, 7), (3, 8), (4, 7))]
    assert np.array_equal(noise.numpy().view(np.uint32), np.stack(want).view(np.uint32))
    assert not torch.equal(noise[0], noise[1]) and not torch.equal(noise[0], noise[2])
    assert bool(torch.isfinite(noise).all())

    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 64)).astype(np.float32))
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    draws = [
        int(sample_tokens(logits, torch.tensor([2.0]), torch.tensor([3]), torch.tensor([1.0]),
                          torch.tensor([s]), torch.tensor([5]))[0])
        for s in range(20)
    ]
    assert set(draws) <= top3 and len(set(draws)) > 1
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)


def test_shard_caches_is_the_jax_keyword_and_raises(model):
    """The dense engine takes the JAX engine's ``shard_caches`` keyword. A
    callable without a mesh is a placement, as in JAX: applied once to the
    fresh caches, the model unsharded, the tokens the unsharded engine's.
    One that changes the caches' shapes is no placement and raises. (The
    tensor-parallel callable: tests/test_torch_sharded_serving.py.)"""
    _, _, tcfg, tparams = model
    _, want = _serve(torch_engine, tcfg, tparams, shard_caches=None)
    seen = []
    _, got = _serve(torch_engine, tcfg, tparams, shard_caches=lambda caches: seen.append(caches) or caches)
    assert got == want and len(seen) == 1
    with pytest.raises(ValueError, match="placement only"):
        torch_engine.ServingEngine(tparams, tcfg, max_slots=1, max_seq=64, shard_caches=lambda caches: caches[:1])
