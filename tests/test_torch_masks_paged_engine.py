"""Parity of the PyTorch port's paged ring and paged attention sinks with the JAX package.

A sliding-window model served by PagedServingEngine owns ceil((window +
chunk) / page) + 2 physical pages a slot (one more, pinned as logical page
0, with sinks) and maps its logical pages onto them modulo their count. The
port's engine (plain kernel versions on the CPU) must give the JAX engine's
greedy tokens (Pallas kernels in interpret mode) on the same parameters,
and the dense rolling + sinks engine's. fp32 weights keep argmax ties
deterministic, so tokens are compared exactly. The paged layer steps are
in tests/test_torch_masks_paged_layer.py, the ring cache and the dense
engine in tests/test_torch_masks_engine.py.
"""

import dataclasses

import jax
import numpy as np
import pytest

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import paged_engine as jax_paged
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving import paged_engine as torch_paged

CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)


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


PAGED_ENGINES = {
    "paged ring": dict(sliding_window=32),
    "paged + sinks": dict(sliding_window=32, attention_sinks=8),
}


@pytest.mark.parametrize("name", list(PAGED_ENGINES))
def test_paged_masked_engine_matches_jax(model, name):
    """The paged ring: a 700-token prompt owns 4 physical pages (5 with the
    pinned sink page) for its 6 logical ones, the table wraps, and the
    greedy tokens are JAX's; every page goes back to the pool."""
    fields = PAGED_ENGINES[name]
    jparams, tparams = model
    prompts = _prompts(9, (700,))
    kw = dict(max_slots=1, num_pages=8, pages_per_slot=6, page_size=128, prefill_chunk=128)
    j_eng = jax_paged.PagedServingEngine(jparams, jt.ModelConfig(**CFG, **fields), **kw)
    t_eng = torch_paged.PagedServingEngine(tparams, tt.ModelConfig(**CFG, **fields), **kw)
    owned = []
    admit = t_eng._admit_one
    t_eng._admit_one = lambda req, slot: admit(req, slot) and (owned.append(len(t_eng.slot_pages[slot])) or True)
    assert _serve(torch_engine, t_eng, prompts, 4) == _serve(jax_paged, j_eng, prompts, 4)
    assert owned == [5 if "sinks" in name else 4]
    assert t_eng.alloc.free_count == j_eng.alloc.free_count == 7 and not t_eng.slot_pages


def test_paged_sinks_equal_dense_sinks_and_prefix_cache_refused(model):
    """Paged StreamingLLM (pinned page 0 + ring) gives the dense rolling +
    sinks engine's tokens; a window with the prefix cache is refused, as in
    JAX (the ring rewrites prompt pages in place)."""
    _, tparams = model
    prompts = _prompts(10, (700,))
    cfg = tt.ModelConfig(**CFG, sliding_window=64, attention_sinks=8)
    paged = torch_paged.PagedServingEngine(tparams, cfg, max_slots=1, num_pages=8, pages_per_slot=6, page_size=128,
                                           prefill_chunk=128)
    dense = torch_engine.ServingEngine(tparams, dataclasses.replace(cfg, rolling=True), max_slots=1, max_seq=768)
    assert _serve(torch_engine, paged, prompts) == _serve(torch_engine, dense, prompts)
    with pytest.raises(ValueError, match="prefix_cache"):
        torch_paged.PagedServingEngine(tparams, cfg, max_slots=1, num_pages=8, pages_per_slot=5, prefix_cache=True)
    with pytest.raises(ValueError, match="pinned first page"):
        torch_paged.PagedServingEngine(tparams, dataclasses.replace(cfg, attention_sinks=128), max_slots=1,
                                       num_pages=8, pages_per_slot=5)
