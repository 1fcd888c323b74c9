"""Parity of the PyTorch port's paged masked layer steps with the JAX package.

A chunk over the paged ring (logical pages below the window alias newer
physical ones) with sinks and a softcap, the deferred decode step and the
write-first one, and the model's write-first paged decode step for a
window of 1, against the JAX package on the same parameters
(``params_from_jax``) and numpy-seeded inputs. On the JAX side attention
runs through the Pallas kernels in interpret mode, on the port's side
through the plain versions.

Tolerances: layer outputs and pages 1e-4 (fp32, summation order only);
lengths equal; the model's decode logits 1e-3 (two layers and the output
head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax, params_from_jax

OP_TOL = 1e-4
CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")


def _diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("sinks,cap", [(4, 5.0)])
def test_paged_ring_chunk_and_decode_match_jax(sinks, cap):
    """A chunk over the paged ring (logical pages below the window alias
    newer ones), then the deferred decode step (window - 1, the softcapped
    self term) and the write-first one: outputs equal to the JAX layer's."""
    fields = dict(sliding_window=200, attention_sinks=sinks, logit_softcap=cap)
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    jp = jattn.init_attention_params(jax.random.key(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    table = np.zeros((2, 8), np.int32)
    table[0] = [1, 2, 3, 4, 5, 2, 3, 4] if sinks else [1, 2, 3, 4, 1, 2, 3, 4]  # ring of 4 (+ pinned page 1)
    pages = [rng.uniform(-1, 1, (6, 2, 128, 32)).astype(np.float32) for _ in range(2)]
    lengths = np.asarray([768, 0], np.int32)
    jc = jpaged.PagedKVCache(*(jnp.asarray(x) for x in (*pages, table, lengths)))
    tc = kv_cache_from_jax(jc, device="cpu")
    x = rng.normal(size=(1, 128, 64)).astype(np.float32) * (4.0 if cap else 1.0)
    j_out, jc = jattn.attention_prefill_chunk_paged(jp, jcfg, jnp.asarray(x), jc, 0, 768, 896)
    t_out, tc = tattn.attention_prefill_chunk_paged(tp, tcfg, torch.from_numpy(x), tc, 0, 768, 896)
    assert _diff(t_out, j_out) <= OP_TOL
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    j_out, _ = jattn.attention_decode_paged_deferred(jp, jcfg, jnp.asarray(x1), jc)
    t_out, _ = tattn.attention_decode_paged_deferred(tp, tcfg, torch.from_numpy(x1), tc)
    assert _diff(t_out, j_out) <= OP_TOL
    j_out, jc = jattn.attention_decode_paged(jp, jcfg, jnp.asarray(x1), jc)
    t_out, tc = tattn.attention_decode_paged(tp, tcfg, torch.from_numpy(x1), tc)
    assert _diff(t_out, j_out) <= OP_TOL
    assert _diff(tc.k_pages, jc.k_pages) <= OP_TOL and tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [897, 1]


def test_write_first_decode_for_window_one_matches_jax():
    """sliding_window == 1 leaves the deferred step a window of 0, so the
    paged decode step writes first (K9), then attends, as in JAX."""
    cfg = dict(CFG, sliding_window=1)
    jcfg, tcfg = jt.ModelConfig(**cfg), tt.ModelConfig(**cfg)
    jp = jt.init_model_params(jax.random.key(6), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jc = jt.init_paged_caches(jcfg, num_pages=5, num_slots=2, pages_per_slot=2, page_size=128)
    tc = tt.init_paged_caches(tcfg, num_pages=5, num_slots=2, pages_per_slot=2, page_size=128, device="cpu")
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    jc = [c._replace(page_table=jnp.asarray(table), lengths=jnp.asarray([5, 0], jnp.int32)) for c in jc]
    tc.page_table.copy_(torch.from_numpy(table))
    tc = tc._replace(lengths=torch.tensor([5, 0], dtype=torch.int32))
    toks = np.asarray([[3], [7]], np.int32)
    j_logits, jc = jt.decode_step_logits_paged(jp, jcfg, jnp.asarray(toks), jc)
    t_logits, tc = tt.decode_step_logits_paged(tp, tcfg, torch.from_numpy(toks), tc)
    assert _diff(t_logits, j_logits) <= 1e-3
    assert tc.lengths.tolist() == np.asarray(jc[0].lengths).tolist() == [6, 1]
