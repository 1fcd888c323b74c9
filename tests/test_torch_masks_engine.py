"""Parity of the PyTorch port's masked model steps and engines with the JAX package.

The rolling ring-buffer cache and its writes, attention sinks, the
sliding window and the logit softcap through the dense serving engine
(the layer steps are in tests/test_torch_masks_layer.py, the paged layer
steps and the paged engine's ring in tests/test_torch_masks_paged_engine.py). The JAX parameter tree goes through ``params_from_jax`` so both
packages compute the same function; inputs come from numpy with a seed. On
the JAX side attention runs through the Pallas kernels in interpret mode,
on the port's side through the plain versions.

Tolerances: cache writes are copies and must be EQUAL; engines compare
greedy tokens exactly (fp32 weights keep argmax ties deterministic, as
tests/test_torch_serving.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax, params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine

CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")


def _equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if want.dtype.itemsize == 1:
        return np.array_equal(got.contiguous().view(torch.uint8).numpy(), want.view(np.uint8))
    return np.array_equal(got.numpy(), want)


def _assert_caches_equal(tc, jc):
    for name in ("k", "v", "k_scales", "v_scales", "lengths"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert (t is None) == (j is None), name
        assert t is None or _equal(t, j), name


# ---------------------------------------------------------------- the ring cache


@pytest.mark.parametrize(
    "window,chunk,sinks,max_seq",
    [(96, 64, 0, 512), (96, 0, 0, 512), (4096, 256, 0, 16384), (4096, 256, 4, 16384), (192, 64, 32, 2048), (96, 64, 0, 128)],
)
def test_ring_rows_match_jax(window, chunk, sinks, max_seq):
    """rolling_buffer_len and the ring cache's shape: Mistral's 4096 window
    at chunk 256 gives 4352 rows (4480 with sinks), capped at max_seq."""
    fields = dict(sliding_window=window, rolling=True, attention_sinks=sinks)
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    rows = tattn.rolling_buffer_len(tcfg, max_seq, chunk)
    assert rows == jattn.rolling_buffer_len(jcfg, max_seq, chunk)
    cache = tattn.init_kv_cache(tcfg, 2, max_seq, device="cpu", prefill_chunk=chunk)
    assert tuple(cache.k.shape) == tuple(jattn.init_kv_cache(jcfg, 2, max_seq, prefill_chunk=chunk).k.shape) == (2, 2, rows, 32)
    if (window, chunk, sinks) == (4096, 256, 0):
        assert rows == 4352


@pytest.mark.parametrize(
    "fields,chunk,match",
    [
        (dict(rolling=True), 0, "requires sliding_window"),
        (dict(sliding_window=64, attention_sinks=4), 0, "requires rolling"),
        (dict(sliding_window=64, rolling=True, attention_sinks=4), 64, "must not exceed sliding_window"),
    ],
)
def test_ring_cache_checks_match_jax(fields, chunk, match):
    with pytest.raises(ValueError, match=match):
        jattn.init_kv_cache(jattn.AttentionConfig(**ATTN, **fields), 1, 512, prefill_chunk=chunk)
    with pytest.raises(ValueError, match=match):
        tattn.init_kv_cache(tattn.AttentionConfig(**ATTN, **fields), 1, 512, device="cpu", prefill_chunk=chunk)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("sinks", [0, 4])
def test_ring_writes_equal_jax(sinks, kv_quant):
    """A prefill write longer than the ring (only the rows it can hold
    survive), then decode writes past the ring's rows: payload, scales and
    lengths (every position written, never clamped) equal to JAX's."""
    fields = dict(sliding_window=96, rolling=True, attention_sinks=sinks, kv_quant=kv_quant)
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    jc = jattn.init_kv_cache(jcfg, 2, 1024, prefill_chunk=32)
    tc = tattn.init_kv_cache(tcfg, 2, 1024, device="cpu", prefill_chunk=32)
    rng = np.random.default_rng(0)
    t = 200 if sinks else 300  # past the ring's 128 (+ 128 sink) rows
    k, v = (rng.uniform(-1, 1, (2, 2, t, 32)).astype(np.float32) for _ in range(2))
    start = np.zeros((2,), np.int32)
    jc = jattn.write_cache(jcfg, jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(start))
    tc = tattn.write_cache(tcfg, tc, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(start))
    _assert_caches_equal(tc, jc)
    for step in range(3):
        k1, v1 = (rng.uniform(-1, 1, (2, 2, 1, 32)).astype(np.float32) for _ in range(2))
        lengths = np.asarray(jc.lengths)
        jc = jattn.write_cache(jcfg, jc, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(lengths))
        tc = tattn.write_cache(tcfg, tc, torch.from_numpy(k1), torch.from_numpy(v1), tc.lengths)
        _assert_caches_equal(tc, jc)
    assert tc.lengths.tolist() == [t + 3, t + 3]


def test_kv_cache_from_jax_carries_the_ring():
    """kv_cache_from_jax brings a JAX ring cache across as it is: the rows
    in ring order and lengths past the ring's rows, so both packages start
    from the same ring."""
    cfg = jattn.AttentionConfig(**ATTN, sliding_window=96, rolling=True)
    jc = jattn.init_kv_cache(cfg, 1, 1024, prefill_chunk=32)
    k = np.random.default_rng(1).uniform(-1, 1, (1, 2, 300, 32)).astype(np.float32)
    jc = jattn.write_cache(cfg, jc, jnp.asarray(k), jnp.asarray(k), jnp.zeros((1,), jnp.int32))
    tc = kv_cache_from_jax(jc, device="cpu")
    _assert_caches_equal(tc, jc)
    assert tc.lengths.tolist() == [300] and tc.k.shape[2] == 128


# ---------------------------------------------------------------- the engines


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, CFG["vocab_size"], n)) for n in lens]


def _serve(mod, eng, prompts, new_tokens=8):
    out = eng.run([mod.Request(id=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)])
    return {i: c.tokens for i, c in out.items()}


DENSE_ENGINES = {  # ModelConfig fields, engine keywords
    "rolling": (dict(sliding_window=32, rolling=True), dict(max_slots=2, max_seq=512, prefill_chunk=64)),
    "rolling + sinks": (dict(sliding_window=64, rolling=True, attention_sinks=8),
                        dict(max_slots=2, max_seq=512, prefill_chunk=64)),
}


@pytest.mark.parametrize("name", list(DENSE_ENGINES))
def test_dense_masked_engine_matches_jax(model, name):
    """The rolling engine (ring of 128 rows; with sinks 128 + 128, the chunk
    clamped to window - sinks = 56) serves prompts of 200 and 90 tokens past
    the ring with JAX's greedy tokens."""
    fields, kw = DENSE_ENGINES[name]
    jparams, tparams = model
    prompts = _prompts(7, (200, 90))
    j_eng = jax_engine.ServingEngine(jparams, jt.ModelConfig(**CFG, **fields), **kw)
    t_eng = torch_engine.ServingEngine(tparams, tt.ModelConfig(**CFG, **fields), **kw)
    assert t_eng.chunk == j_eng.chunk == (56 if "sinks" in name else 64)
    assert t_eng.caches[0].k.shape[2] == j_eng.caches[0].k.shape[2] < 512
    assert _serve(torch_engine, t_eng, prompts) == _serve(jax_engine, j_eng, prompts)


def test_rolling_engine_equals_dense_window_engine(model):
    """The ring changes memory, not numbers: the rolling engine and the
    dense engine with the same window give the same tokens, and a softcap
    changes them."""
    _, tparams = model
    prompts = _prompts(8, (200, 90))
    kw = dict(max_slots=2, max_seq=512, prefill_chunk=64)
    rolling = _serve(torch_engine, torch_engine.ServingEngine(tparams, tt.ModelConfig(**CFG, sliding_window=32, rolling=True), **kw), prompts)
    dense = _serve(torch_engine, torch_engine.ServingEngine(tparams, tt.ModelConfig(**CFG, sliding_window=32), **kw), prompts)
    assert rolling == dense
    capped = _serve(torch_engine, torch_engine.ServingEngine(tparams, tt.ModelConfig(**CFG, sliding_window=32, logit_softcap=0.05), **kw), prompts)
    assert capped != dense
