"""The port's dense ``ServingEngine.warmup`` against the JAX package's.

JAX's ``tests/test_serving.py`` warmup cases on ``ModelConfig.tiny()``
(fp32, so argmax ties are deterministic) with the same weights on both
sides through ``params_from_jax``: after ``warmup()`` the port's tokens
equal a cold JAX engine's, the counters are zero, the decode blocks walk
every power-of-two length, ``prompt_len`` is clamped (the greedy request's;
a second, sampled request of one token builds the sampled programs) and a
``max_seq`` too small raises JAX's ``ValueError``.
"""

import inspect

import jax
import numpy as np
import pytest

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import decode_loop as jax_decode_loop
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import decode_loop
from flash_attention_tpu_torch.serving import engine as torch_engine

TINY = dict(dtype="float32")
REQS = [((5, 9, 2), 6), ((100, 3, 44, 8, 21, 60, 7), 9), ((64,), 4)]


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig.tiny(**TINY)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig.tiny(**TINY), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod):
    return [mod.Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(REQS)]


def _tokens(out):
    return {i: c.tokens for i, c in out.items()}


def _engine(model, **kw):
    _, _, tcfg, tparams = model
    return torch_engine.ServingEngine(tparams, tcfg, **{"max_slots": 2, "max_seq": 64, "decode_block_steps": 8, **kw})


def test_warm_tokens_equal_a_cold_jax_engine(model):
    jcfg, jparams, _, _ = model
    cold = jax_engine.ServingEngine(jparams, jcfg, max_slots=2, max_seq=64, decode_block_steps=8)
    want = _tokens(cold.run(_requests(jax_engine)))
    eng = _engine(model)
    eng.warmup()
    assert (eng.steps, eng.decode_tokens, eng.decode_time_s, eng.events) == (0, 0, 0.0, [])
    assert _tokens(eng.run(_requests(torch_engine))) == want
    assert eng.decode_tokens > 0
    eng.warmup()  # a second call is safe and leaves the counters at zero again
    assert (eng.steps, eng.decode_tokens, eng.decode_time_s, eng.events) == (0, 0, 0.0, [])
    assert _tokens(eng.run(_requests(torch_engine))) == want


def test_warmup_walks_every_block_length(model):
    """JAX's test_warmup_walks_every_block_length: 2B new tokens leave a
    budget of 2B - 1 after the first token, so blocks of 8, 4, 2 and 1."""
    eng = _engine(model, max_slots=1)
    orig = eng._decode_multi
    seen = set()

    def spy(params, last, caches, active, t, k_, p, s, k, greedy=False):
        seen.add(k)
        return orig(params, last, caches, active, t, k_, p, s, k, greedy)

    eng._decode_multi = spy
    eng.warmup()
    assert seen == {8, 4, 2, 1}, seen


@pytest.mark.parametrize("prompt_len, want", [(None, 48), (1000, 48), (5, 5), (0, 1), (-3, 1)])
def test_prompt_len_is_clamped(model, prompt_len, want):
    eng = _engine(model)
    seen = []
    orig = eng.run

    def spy(requests):
        seen.extend((len(r.prompt), r.max_new_tokens, r.id) for r in requests)
        return orig(requests)

    eng.run = spy
    eng.warmup(prompt_len=prompt_len)
    # The greedy request of the clamped length, then the sampled one-token request that builds the sampled programs.
    assert seen == [(want, 16, (1 << 62) + 41), (1, 16, (1 << 62) + 42)]


def test_max_seq_too_small_raises_jax_message(model):
    jcfg, jparams, _, _ = model
    with pytest.raises(ValueError) as theirs:
        jax_engine.ServingEngine(jparams, jcfg, max_slots=1, max_seq=16, decode_block_steps=8).warmup()
    with pytest.raises(ValueError) as ours:
        _engine(model, max_slots=1, max_seq=16).warmup()
    assert str(ours.value) == str(theirs.value) == "max_seq=16 leaves no room for a warmup prompt (needs >= 17)"


def test_warmup_engine_takes_jax_signature():
    assert str(inspect.signature(decode_loop.warmup_engine)) == str(inspect.signature(jax_decode_loop.warmup_engine))
    for cls in (torch_engine.ServingEngine, jax_engine.ServingEngine):
        assert str(inspect.signature(cls.warmup)) == "(self, *, prompt_len: 'int | None' = None) -> 'None'"
