"""Parity of the PyTorch port's quantized paged model steps and paged
engine with the JAX package.

The same tiny fp32 model (2 layers, head_dim 32, pages of 128 rows; weights
drawn by the JAX package and carried across by ``params_from_jax``) runs
through the JAX package's model functions and engines, whose Pallas kernels
run in interpret mode, and through the port's, whose wrappers take their
plain PyTorch versions for CPU tensors. Variants: a KV cache of int8,
fp8_e4m3 or fp8_e5m2, and int8 (W8A16) weights. The quantized operations
themselves are held against JAX in tests/test_torch_quant.py, the dense
model steps and engine in tests/test_torch_quant_engine.py.

Tolerances: model logits 1e-3 (fp32; the kernels' sums run in another
order and the quantized cache rows are bit-equal); greedy tokens of both
engines identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu.serving import paged_engine as jax_paged_engine
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving import paged_engine as torch_paged_engine

LOGIT_TOL = 1e-3
PAGE = 128
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
def test_paged_model_steps_quantized_match_jax(variant):
    """Two 128-token chunks into slot 1 over quantized pages (K8q's
    function, K8's quantizing prefill write), then deferred decode steps:
    the self term at full precision, every layer's row quantized by one
    K10q write (JAX mirrors both)."""
    jcfg, tcfg, jparams, tparams = _model(variant)
    table = np.array([[0, 0], [4, 2], [5, 1]], np.int32)
    kw = dict(num_pages=7, num_slots=3, pages_per_slot=2, page_size=PAGE)
    j_caches = [c._replace(page_table=jnp.asarray(table)) for c in jt.init_paged_caches(jcfg, **kw)]
    t_cache = tt.init_paged_caches(tcfg, **kw, device="cpu")
    t_cache.page_table.copy_(torch.from_numpy(table))
    toks = np.random.default_rng(15).integers(0, 128, (1, 256)).astype(np.int32)
    for lo, hi in ((0, 128), (128, 256)):
        j_logits, j_caches = jt.prefill_chunk_paged(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), j_caches,
                                                    jnp.int32(1), jnp.int32(lo), hi)
        t_logits, t_cache = tt.prefill_chunk_paged(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), t_cache, 1, lo, hi)
        assert _diff(t_logits, j_logits) <= LOGIT_TOL
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
    assert t_cache.quantized() == (variant != "w8")
    assert t_cache.lengths.tolist() == np.asarray(j_caches[0].lengths).tolist() == [2, 252, 5]


ENGINE_REQS = [((5, 9, 2), 5), ((100, 3, 44, 8, 21, 60, 7), 6), ((64,), 4)]  # 3 requests, 2 slots


def _serve(engines, paged, cfg, params):
    """Greedy tokens of ENGINE_REQS through one package's dense or paged
    engine; ``engines`` is (engine module, paged engine module)."""
    if paged:
        eng = engines[1].PagedServingEngine(params, cfg, max_slots=2, num_pages=8, pages_per_slot=1, page_size=PAGE)
    else:
        eng = engines[0].ServingEngine(params, cfg, max_slots=2, max_seq=128, prefill_chunk=16)
    out = eng.run([engines[0].Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(ENGINE_REQS)])
    return {i: c.tokens for i, c in out.items()}


JAX_ENGINES = (jax_engine, jax_paged_engine)
TORCH_ENGINES = (torch_engine, torch_paged_engine)


@pytest.mark.parametrize("variant", ["int8", "fp8_e4m3", "w8"])
def test_paged_engine_quantized_matches_jax(variant):
    """The paged engine gives the JAX paged engine's greedy tokens on a
    quantized KV cache and on int8 weights; on an int8 cache its tokens for
    these requests are also the dense engine's, as the JAX package asserts
    for its own (tests/test_paged_engine.py:136)."""
    jcfg, tcfg, jparams, tparams = _model(variant)
    got = _serve(TORCH_ENGINES, True, tcfg, tparams)
    assert got == _serve(JAX_ENGINES, True, jcfg, jparams)
    assert [len(got[i]) for i in range(len(ENGINE_REQS))] == [n for _, n in ENGINE_REQS]
    if variant == "int8":
        assert got == _serve(TORCH_ENGINES, False, tcfg, tparams)


def test_prefix_cache_quantized_tokens_unchanged():
    """Shared prefix pages carry their scales: over an fp8 cache the second
    request hits the first's two prompt pages and both give the tokens of an
    engine without the prefix cache."""
    _, tcfg, _, tparams = _model("fp8_e4m3")
    rng = np.random.RandomState(23)
    prefix = tuple(int(t) for t in rng.randint(0, 128, size=256))
    reqs = [torch_engine.Request(id=i, prompt=prefix + tuple(int(t) for t in rng.randint(0, 128, size=40)),
                                 max_new_tokens=6) for i in range(2)]
    pool = dict(max_slots=2, num_pages=16, pages_per_slot=4, page_size=PAGE, prefill_chunk=128)
    tokens = {}
    for cached in (False, True):
        eng = torch_paged_engine.PagedServingEngine(tparams, tcfg, **pool, prefix_cache=cached)
        tokens[cached] = [eng.run([r])[r.id].tokens for r in reqs]
        assert eng.caches.quantized()
    assert eng.prefix_hits == 2 and tokens[True] == tokens[False]
