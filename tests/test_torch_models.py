"""Parity of the PyTorch port's model modules with the JAX package.

The JAX parameter tree goes through ``params_from_jax`` so both packages
compute the same function; inputs come from numpy with a seed. The model is
the tiny fp32 config of tests/test_serving.py; attention runs through the
Pallas kernels in interpret mode on the JAX side and through the plain
versions on the port's side.

Tolerances: fp32 ops 1e-4 and logits 1e-3 (summation order only); bf16 RoPE
one bf16 step of its output (the same fp32 rotation, rounded once).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jax_attention
from flash_attention_tpu.models import rope as jax_rope
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.models.rope import apply_rope
from flash_attention_tpu_torch.ops.reference import reference_attention

OP_TOL = 1e-4
LOGIT_TOL = 1e-3
CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jt.ModelConfig(**CFG), tt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


def _tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 4, 16, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 1, 16)).astype(np.int32)
    want = jax_rope.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos))
    got = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same fp32 rotation rounded once; one bf16 step of |x| <= 1.5.
    assert _diff(got, jnp.asarray(want, jnp.float32)) <= (OP_TOL if dtype == "float32" else 2**-7)


def test_rms_norm_and_swiglu_match_jax(model):
    _, _, jparams, tparams = model
    x = np.random.default_rng(1).normal(size=(2, 5, 128)).astype(np.float32)
    lp_j, lp_t = jparams["layers"][0], tparams["layers"][0]
    w = np.random.default_rng(2).uniform(0.5, 1.5, 128).astype(np.float32)
    assert _diff(tt.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
                 jt.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)) <= OP_TOL
    assert _diff(tt.swiglu(torch.from_numpy(x), lp_t["mlp"]), jt.swiglu(jnp.asarray(x), lp_j["mlp"])) <= OP_TOL


def test_params_from_jax_keeps_tree_and_bf16_bits():
    jcfg = jt.ModelConfig(**{**CFG, "dtype": "bfloat16"})
    jparams = jt.init_model_params(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    j_leaves, j_tree = jax.tree.flatten(jparams)
    t_leaves = jax.tree.leaves(tparams)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tparams)) == j_tree
    for j, t in zip(j_leaves, t_leaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_init_model_params_shapes_match_jax_and_are_seeded():
    tcfg = tt.ModelConfig(**CFG)
    want = jax.eval_shape(lambda: jt.init_model_params(jax.random.key(0), jt.ModelConfig(**CFG)))
    a = tt.init_model_params(torch.Generator().manual_seed(5), tcfg)
    b = tt.init_model_params(torch.Generator().manual_seed(5), tcfg)
    assert jax.tree.map(lambda s: tuple(s.shape), want) == jax.tree.map(lambda t: tuple(t.shape), a)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_prefill_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(4, (2, 16))
    j_logits, j_caches = jt.prefill(jparams, jcfg, jnp.asarray(toks), jt.init_caches(jcfg, 2, MAX_SEQ))
    t_logits, t_caches = tt.prefill(tparams, tcfg, torch.from_numpy(toks), tt.init_caches(tcfg, 2, MAX_SEQ, device="cpu"))
    assert t_logits.shape == tuple(j_logits.shape) and t_logits.dtype == torch.float32
    assert _diff(t_logits, j_logits) <= LOGIT_TOL
    for jc, tc in zip(j_caches, t_caches):
        assert _diff(tc.k, jc.k) <= OP_TOL and _diff(tc.v, jc.v) <= OP_TOL
        assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [16, 16]


def test_prefill_chunk_then_decode_match_jax(model):
    """Two chunks of one slot (the second attending the first through the
    cache), then greedy decode steps for every slot."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(5, (1, 32))
    j_caches, t_caches = jt.init_caches(jcfg, 3, MAX_SEQ), tt.init_caches(tcfg, 3, MAX_SEQ, device="cpu")
    for lo, hi in ((0, 16), (16, 32)):
        j_logits, j_caches = jt.prefill_chunk(
            jparams, jcfg, jnp.asarray(toks[:, lo:hi]), j_caches, jnp.int32(1), jnp.int32(lo), hi
        )
        t_logits, t_caches = tt.prefill_chunk(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), t_caches, 1, lo, hi)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
    assert t_caches[0].lengths.tolist() == np.asarray(j_caches[0].lengths).tolist() == [0, 32, 0]

    j_tok = jnp.asarray(_tokens(6, (3, 1)))
    t_tok = torch.from_numpy(np.array(j_tok))
    for _ in range(3):
        j_logits, _ = jt.decode_step_logits(jparams, jcfg, j_tok, j_caches)
        j_tok, j_caches = jt.decode_step(jparams, jcfg, j_tok, j_caches)
        t_logits, _ = tt.decode_step_logits(tparams, tcfg, t_tok, t_caches)
        t_tok, t_caches = tt.decode_step(tparams, tcfg, t_tok, t_caches)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
        assert t_tok.tolist() == np.asarray(j_tok).tolist()
    assert t_caches[0].lengths.tolist() == np.asarray(j_caches[0].lengths).tolist()


@pytest.mark.parametrize("start", [[0, 5, 63], [64, 64, 3]])
def test_decode_write_drops_at_capacity(start):
    """A decode write at max_seq is dropped, not clamped onto the last row,
    exactly as in the JAX package."""
    jcfg = jt.ModelConfig(**CFG).attention_config()
    tcfg = tt.ModelConfig(**CFG).attention_config()
    rng = np.random.default_rng(7)
    base = rng.normal(size=(3, 2, MAX_SEQ, 32)).astype(np.float32)
    new = rng.normal(size=(3, 2, 1, 32)).astype(np.float32)
    starts = np.array(start, np.int32)
    jc = jax_attention.KVCache(jnp.asarray(base), jnp.asarray(base), None, None, jnp.asarray(starts))
    jc = jax_attention.write_cache(jcfg, jc, jnp.asarray(new), jnp.asarray(new), jnp.asarray(starts))
    tc = tattn.KVCache(torch.from_numpy(base.copy()), torch.from_numpy(base.copy()), torch.from_numpy(starts))
    tc = tattn.write_cache(tcfg, tc, torch.from_numpy(new), torch.from_numpy(new), torch.from_numpy(starts))
    assert np.array_equal(tc.k.numpy(), np.asarray(jc.k))
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


@pytest.mark.parametrize(
    "override",
    [
        {"kv_quant": "int8", "sliding_window": 32},
        {"weight_quant": "int8", "logit_softcap": 30.0},
        {"sliding_window": 32},
        {"logit_softcap": 30.0},
        {"sliding_window": 32, "rolling": True},
        {"sliding_window": 64, "rolling": True, "attention_sinks": 4},
    ],
)
def test_unported_configs_raise(override):
    """Training under the serving configs' masks: attention_forward applies
    the config's window and softcap (the cache options rolling, sinks and
    kv_quant do not touch the cache-free path, as in the JAX package) and
    equals the masked oracle over the same projections; train_forward's
    loss has a finite gradient for every float leaf."""
    cfg = tt.ModelConfig(**{**CFG, **override})
    params = tt.init_model_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, CFG["vocab_size"], (1, 41)))
    leaves = [t for t in jax.tree.leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_()
    logits = tt.train_forward(params, cfg, tokens[:, :-1])
    loss = torch.nn.functional.cross_entropy(logits[0], tokens[0, 1:])
    assert all(bool(torch.isfinite(g).all()) for g in torch.autograd.grad(loss, leaves))
    attn_override = {k: v for k, v in override.items() if k != "weight_quant"}
    acfg = dataclasses.replace(tt.ModelConfig(**CFG).attention_config(), **attn_override)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 80, CFG["model_dim"])).astype(np.float32))
    lp = params["layers"][0]["attn"]
    got = tattn.attention_forward(lp, acfg, x)
    q, k, v = tattn._project_qkv(lp, acfg, x, torch.arange(80)[None, None, :])
    o = reference_attention(q, k, v, causal=True, sliding_window=acfg.sliding_window, logit_softcap=acfg.logit_softcap)
    assert float((got - tattn._output_proj(lp, o, x.dtype)).detach().abs().max()) <= OP_TOL
