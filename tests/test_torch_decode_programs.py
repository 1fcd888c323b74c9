"""The decode block as one program (``serving/decode_loop.DecodePrograms``)
on the CPU, against the JAX package's engines.

On ``ModelConfig.tiny()`` in fp32 (argmax ties deterministic) with the same
weights on both sides through ``params_from_jax``, both engines run their
blocks through the programs' static buffers, as the card replays them
(here eagerly, mode "eager", a key's program built at its first block as
the card captures it). Greedy and sampled requests join and leave two slots
between blocks, so the buffers are re-uploaded in place and the lengths
live in one tensor that prefill and decode both write in place: the tokens
and the final lengths equal JAX's. A run after ``warmup()`` gives a cold
run's tokens, ``warmup()`` builds every (k, greedy) key, and the run after
it builds none and runs every block from a built program. Assigning
``engine.caches`` copies into the engine's buffers.
"""

import jax
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu.serving import paged_engine as jax_paged
from flash_attention_tpu.serving.sampling import SamplingParams as JaxSamplingParams
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving import paged_engine as torch_paged
from flash_attention_tpu_torch.serving.sampling import SamplingParams
from flash_attention_tpu_torch.utils.checkpoint import _leaves, load_kv_cache, save_kv_cache

TINY = dict(dtype="float32")
BLOCK = 8
DENSE = dict(max_slots=2, max_seq=64, prefill_chunk=16, decode_block_steps=BLOCK)
PAGED = dict(max_slots=2, num_pages=12, pages_per_slot=4, page_size=16, prefill_chunk=16, decode_block_steps=BLOCK)
# Five requests on two slots: greedy and sampled ones join and leave between blocks, so the blocks run both
# greedy (every active slot at temperature 0) and sampled, at several lengths.
REQS = [
    ((5, 9, 2), 13, {}),
    ((100, 3, 44, 8, 21, 60, 7), 9, dict(temperature=0.9, top_k=20, seed=3)),
    ((64,), 20, {}),
    ((11, 12, 13, 14), 6, dict(temperature=1.3, top_p=0.8, seed=4)),
    (tuple(range(30, 48)), 17, {}),
]
ALL_KEYS = {(1 << i, greedy) for i in range(BLOCK.bit_length()) for greedy in (True, False)}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig.tiny(**TINY)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig.tiny(**TINY), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod, params_cls, first_id=0):
    return [mod.Request(id=first_id + i, prompt=p, max_new_tokens=n, sampling=params_cls(**s))
            for i, (p, n, s) in enumerate(REQS)]


def _tokens(out):
    return {i: c.tokens for i, c in out.items()}


def _port(model, kind):
    _, _, tcfg, tparams = model
    if kind == "dense":
        return torch_engine.ServingEngine(tparams, tcfg, **DENSE)
    return torch_paged.PagedServingEngine(tparams, tcfg, **PAGED)


def _jax(model, kind):
    jcfg, jparams, _, _ = model
    if kind == "dense":
        return jax_engine.ServingEngine(jparams, jcfg, **DENSE)
    return jax_paged.PagedServingEngine(jparams, jcfg, **PAGED)


def _blocks(eng) -> int:
    return sum(1 for event in eng.events if event[0] == "decode")


@pytest.fixture(scope="module")
def jax_runs(model):
    """Each JAX engine's tokens and final lengths after REQS."""
    out = {}
    for kind in ("dense", "paged"):
        eng = _jax(model, kind)
        tokens = _tokens(eng.run(_requests(jax_engine, JaxSamplingParams)))
        out[kind] = (tokens, np.asarray(eng.caches[0].lengths))
    return out


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_programs_give_jax_tokens_and_lengths(model, jax_runs, kind):
    """Greedy and sampled blocks through the static buffers, with slots
    joining and leaving: JAX's tokens, and JAX's lengths in the engine's one
    lengths tensor, which is still the tensor the engine started with (every
    dense layer holding it), with the K/V buffers at their addresses."""
    eng = _port(model, kind)
    lengths = eng._lengths_of(eng.caches)
    kv = [t for t in _leaves(eng.caches) if t is not lengths]  # a paged pool's layers are views: held by address
    got = _tokens(eng.run(_requests(torch_engine, SamplingParams)))
    want_tokens, want_lengths = jax_runs[kind]
    assert got == want_tokens
    assert all(len(got[i]) == n for i, (_, n, _) in enumerate(REQS))
    assert eng._lengths_of(eng.caches) is lengths and np.array_equal(lengths.numpy(), want_lengths)
    if kind == "dense":
        assert all(c.lengths is lengths for c in eng.caches)
    assert [t.data_ptr() for t in kv] == [t.data_ptr() for t in _leaves(eng.caches) if t is not lengths]
    progs = eng.programs
    built = progs.built()
    assert progs.mode == "eager" and progs.captures == len(built)
    assert {greedy for _, greedy in built} == {True, False}, built
    assert progs.captures + progs.replays == _blocks(eng)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_warmup_builds_every_program_and_the_run_builds_none(model, jax_runs, kind):
    eng = _port(model, kind)
    eng.warmup()
    assert eng.programs.built() == ALL_KEYS and eng.programs.captures == len(ALL_KEYS)
    replays = eng.programs.replays
    got = _tokens(eng.run(_requests(torch_engine, SamplingParams, first_id=100)))
    assert eng.programs.captures == len(ALL_KEYS)
    assert eng.programs.replays - replays == _blocks(eng) > 0
    # The warm run's tokens are the cold run's (JAX's), request by request.
    assert {i - 100: t for i, t in got.items()} == jax_runs[kind][0]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_a_second_warm_run_equals_the_first(model, kind):
    """Blocks of built programs, run by run, give the same tokens again."""
    eng = _port(model, kind)
    eng.warmup()
    first = _tokens(eng.run(_requests(torch_engine, SamplingParams)))
    second = _tokens(eng.run(_requests(torch_engine, SamplingParams)))
    assert first == second and eng.programs.captures == len(ALL_KEYS)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_assigning_caches_copies_into_the_engines_buffers(model, tmp_path, kind):
    """``engine.caches = load_kv_cache(path, engine.caches)`` restores the
    values into the buffers the programs hold; a cache of another layout is
    refused."""
    eng = _port(model, kind)
    eng.run(_requests(torch_engine, SamplingParams))
    before = [t.clone() for t in _leaves(eng.caches)]
    tree, buffers = eng.caches, _leaves(eng.caches)
    save_kv_cache(tmp_path / "c.npz", eng.caches)
    for t in buffers:
        t.zero_()
    eng.caches = load_kv_cache(tmp_path / "c.npz", eng.caches)
    assert eng.caches is tree and [t.data_ptr() for t in _leaves(eng.caches)] == [t.data_ptr() for t in buffers]
    assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.caches), before))
    other = _port(model, kind)
    other.caches = eng.caches
    assert all(torch.equal(a, b) for a, b in zip(_leaves(other.caches), before))
    with pytest.raises(ValueError, match="layout"):
        eng.caches = _leaves(eng.caches)[:-1]
