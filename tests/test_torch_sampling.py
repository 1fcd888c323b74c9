"""The port's sampling against the JAX package's, bit for bit.

``gumbel_noise`` draws jax.random's Gumbel noise (threefry2x32 keys folded
with the position, partitionable random bits, the float32 mantissa trick,
and the two logs as XLA computes them on the CPU), so at temperature > 0
``sample_tokens`` and both tiny engines give the JAX package's tokens; the
noise is compared bit for bit, tokens exactly. fp32 weights keep argmax ties
deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu.serving import paged_engine as jax_paged
from flash_attention_tpu.serving.sampling import SamplingParams as JaxSamplingParams
from flash_attention_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving import paged_engine as torch_paged
from flash_attention_tpu_torch.serving.sampling import SamplingParams, gumbel_noise, sample_tokens

CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)


def _jax_gumbel(seeds, positions, vocab):
    def row(seed, pos):
        return jax.random.gumbel(jax.random.fold_in(jax.random.key(seed), pos), (vocab,), jnp.float32)

    return np.asarray(jax.vmap(row)(jnp.asarray(seeds).astype(jnp.uint32), jnp.asarray(positions, jnp.int32)))


@pytest.mark.parametrize("vocab", [1, 7, 128, 32000, 50257])
def test_gumbel_noise_is_jax_bits(vocab):
    seeds = np.array([0, 1, 3, 12345, 2**31 - 1, -5, 7, 7], np.int32)
    positions = np.array([0, 5, 7, 11, 1 << 20, 99, 2**31 - 1, 0], np.int32)
    want = _jax_gumbel(seeds, positions, vocab)
    got = gumbel_noise(torch.from_numpy(seeds), torch.from_numpy(positions), vocab)
    assert got.dtype == torch.float32 and got.shape == (len(seeds), vocab)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_gumbel_noise_is_one_draw_per_row_without_a_host_loop():
    """Row i depends on (seeds[i], positions[i]) alone: a batch equals its
    rows drawn one by one."""
    seeds, positions = torch.tensor([4, 4, 9]), torch.tensor([3, 4, 3])
    batch = gumbel_noise(seeds, positions, 300)
    for i in range(3):
        assert torch.equal(batch[i], gumbel_noise(seeds[i:i + 1], positions[i:i + 1], 300)[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_match_jax_at_temperature(seed):
    rng = np.random.default_rng(seed)
    batch, vocab = 8, 512
    logits = rng.normal(size=(batch, vocab)).astype(np.float32) * 3
    temp = np.array([0.5, 1.0, 2.0, 0.7, 1.3, 1.0, 0.0, 3.0], np.float32)
    top_k = np.array([0, 5, 0, 50, 1, 0, 3, 20], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.5, 1.0, 0.3, 1.0, 0.95], np.float32)
    seeds = rng.integers(0, 2**31 - 1, batch).astype(np.int32)
    pos = rng.integers(0, 4096, batch).astype(np.int32)
    arrays = (logits, temp, top_k, top_p, seeds, pos)
    want = np.asarray(jax_sample_tokens(*map(jnp.asarray, arrays)))
    got = sample_tokens(*map(torch.from_numpy, arrays))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig(**CFG), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# 4 sampled requests and one greedy for 3 slots: slots get refilled.
SAMPLED = [
    ((5, 9, 2), 8, dict(temperature=1.0, seed=11)),
    ((100, 3, 44, 8, 21, 60, 7), 9, dict(temperature=0.8, top_k=20, seed=12)),
    ((64,), 6, dict(temperature=1.5, top_p=0.9, seed=13)),
    ((11, 12, 13, 14), 7, dict(temperature=1.2, top_k=40, top_p=0.8, seed=14)),
    ((90, 2), 5, dict()),
]


def _requests(mod, params_cls):
    return [mod.Request(id=i, prompt=p, max_new_tokens=n, sampling=params_cls(**s))
            for i, (p, n, s) in enumerate(SAMPLED)]


def _tokens(out):
    return {i: c.tokens for i, c in out.items()}


def test_dense_engine_samples_jax_tokens(model):
    jcfg, jparams, tcfg, tparams = model
    want = _tokens(jax_engine.ServingEngine(jparams, jcfg, max_slots=3, max_seq=64).run(
        _requests(jax_engine, JaxSamplingParams)))
    got = _tokens(torch_engine.ServingEngine(tparams, tcfg, max_slots=3, max_seq=64).run(
        _requests(torch_engine, SamplingParams)))
    assert got == want
    assert all(len(got[i]) == n for i, (_, n, _) in enumerate(SAMPLED))


def test_paged_engine_samples_jax_tokens(model):
    jcfg, jparams, tcfg, tparams = model
    pool = dict(max_slots=3, num_pages=16, pages_per_slot=2, page_size=128)
    want = _tokens(jax_paged.PagedServingEngine(jparams, jcfg, **pool).run(_requests(jax_engine, JaxSamplingParams)))
    got = _tokens(torch_paged.PagedServingEngine(tparams, tcfg, **pool).run(_requests(torch_engine, SamplingParams)))
    assert got == want
