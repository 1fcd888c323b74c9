"""Parity of the PyTorch port's quantized dense model steps and dense
engine with the JAX package.

The same tiny fp32 model (2 layers, head_dim 32; weights drawn by the JAX
package and carried across by ``params_from_jax``) runs through the JAX
package's model functions and dense engine, whose Pallas kernels
run in interpret mode, and through the port's, whose wrappers take their
plain PyTorch versions for CPU tensors. Variants: a KV cache of int8,
fp8_e4m3 or fp8_e5m2, and int8 (W8A16) weights. The quantized operations
themselves are held against JAX in tests/test_torch_quant.py, the paged
model steps and engine in tests/test_torch_quant_paged_engine.py.

Tolerances: model logits 1e-3 (fp32; the kernels' sums run in another
order and the quantized cache rows are bit-equal); greedy tokens of the
engines identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine

LOGIT_TOL = 1e-3
CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)


def _diff(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), "non-finite entries differ"
    return float(np.abs(got - want).max())


VARIANTS = {  # ModelConfig overrides
    "int8": {"kv_quant": "int8"},
    "fp8_e4m3": {"kv_quant": "fp8_e4m3"},
    "fp8_e5m2": {"kv_quant": "fp8_e5m2"},
    "w8": {"weight_quant": "int8"},
}
STEP_VARIANTS = ["int8", "fp8_e5m2", "w8"]  # fp8_e4m3 goes through the engine below


def _model(variant):
    jcfg = jt.ModelConfig(**{**CFG, **VARIANTS[variant]})
    tcfg = tt.ModelConfig(**{**CFG, **VARIANTS[variant]})
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("variant", STEP_VARIANTS)
def test_dense_model_steps_quantized_match_jax(variant):
    """Two prefill chunks of one slot (the second reads the first through
    the dequantized visible slice), then greedy decode steps of every slot
    over the quantized cache (K6q's function, the token attended as stored)."""
    jcfg, tcfg, jparams, tparams = _model(variant)
    toks = np.random.default_rng(14).integers(0, 128, (1, 32)).astype(np.int32)
    j_caches, t_caches = jt.init_caches(jcfg, 3, 64), tt.init_caches(tcfg, 3, 64, device="cpu")
    for lo, hi in ((0, 16), (16, 32)):
        j_logits, j_caches = jt.prefill_chunk(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), j_caches,
                                              jnp.int32(1), jnp.int32(lo), hi)
        t_logits, t_caches = tt.prefill_chunk(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), t_caches, 1, lo, hi)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
    assert t_caches[0].quantized() == (variant != "w8")
    j_tok = jnp.asarray([[3], [5], [7]], jnp.int32)
    t_tok = torch.from_numpy(np.array(j_tok))
    for _ in range(3):
        j_logits, j_caches = jt.decode_step_logits(jparams, jcfg, j_tok, j_caches)
        t_logits, t_caches = tt.decode_step_logits(tparams, tcfg, t_tok, t_caches)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
        j_tok = jnp.argmax(j_logits, axis=-1)[:, None].astype(jnp.int32)
        t_tok = torch.argmax(t_logits, dim=-1)[:, None].to(torch.int32)
        assert t_tok.tolist() == np.asarray(j_tok).tolist()
    assert t_caches[0].lengths.tolist() == np.asarray(j_caches[0].lengths).tolist() == [3, 35, 3]


ENGINE_REQS = [((5, 9, 2), 5), ((100, 3, 44, 8, 21, 60, 7), 6), ((64,), 4)]  # 3 requests, 2 slots


def _serve(engine, cfg, params):
    """Greedy tokens of ENGINE_REQS through one package's dense engine module."""
    eng = engine.ServingEngine(params, cfg, max_slots=2, max_seq=128, prefill_chunk=16)
    out = eng.run([engine.Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(ENGINE_REQS)])
    return {i: c.tokens for i, c in out.items()}


@pytest.mark.parametrize("variant", ["int8", "fp8_e4m3", "w8"])
def test_dense_engine_quantized_matches_jax(variant):
    """The dense engine gives the JAX dense engine's greedy tokens on a
    quantized KV cache and on int8 weights."""
    jcfg, tcfg, jparams, tparams = _model(variant)
    got = _serve(torch_engine, tcfg, tparams)
    assert got == _serve(jax_engine, jcfg, jparams)
    assert [len(got[i]) for i in range(len(ENGINE_REQS))] == [n for _, n in ENGINE_REQS]
