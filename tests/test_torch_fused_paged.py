"""Parity of the paged decode's self term (F4: ``paged_decode_attention(self_kv=...)``,
K7's in-launch merge on the card) with the JAX package.

On the CPU the wrapper runs K7's plain version followed by
``merge_self_plain``; here the port's ``attention_decode_paged_deferred``,
which now makes that one call, is held to the JAX package's (K7 in
interpret mode, then its merge) on the same parameters and numpy-seeded
inputs: no mask, a window, a softcap, a window with sinks, an int8 and an
e4m3 pool, each with a slot of length 0 (whose output is its own v_new
through wo). Outputs within 1e-5 (fp32: the same function summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax, params_from_jax
from flash_attention_tpu_torch.ops import paged as tpaged

TOL = 1e-5
ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")
CASES = {
    "plain": (dict(), "none"),
    "window": (dict(sliding_window=200), "none"),
    "softcap": (dict(logit_softcap=5.0), "none"),
    "window + sinks": (dict(sliding_window=200, attention_sinks=4), "none"),
    "int8 pool": (dict(), "int8"),
    "e4m3 pool": (dict(), "fp8_e4m3"),
}


def _pages(rng, mode: str):
    """A JAX PagedKVCache of 6 pages of 128 rows, 2 slots (slot 1 empty)."""
    table = np.asarray([[1, 3, 5, 2], [4, 0, 0, 0]], np.int32)
    lengths = np.asarray([420, 0], np.int32)
    rows = [rng.uniform(-1, 1, (6, 2, 128, 32)).astype(np.float32) for _ in range(2)]
    if mode == "none":
        return jpaged.PagedKVCache(*(jnp.asarray(x) for x in (*rows, table, lengths)))
    payload = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}[mode]
    qk, qv = (jquant.quantize_values(jnp.asarray(x), payload) for x in rows)
    scales = [jnp.swapaxes(q.scales, -1, -2) for q in (qk, qv)]  # [P, H, 1, page]
    return jpaged.PagedKVCache(qk.values, qv.values, jnp.asarray(table), jnp.asarray(lengths), *scales)


@pytest.mark.parametrize("case", list(CASES))
def test_deferred_self_term_matches_jax(case):
    fields, mode = CASES[case]
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    jp = jattn.init_attention_params(jax.random.key(7), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(len(case))
    jc = _pages(rng, mode)
    tc = kv_cache_from_jax(jc, device="cpu")
    x = rng.normal(size=(2, 1, 64)).astype(np.float32) * (4.0 if "softcap" in case else 1.0)
    j_out, (jk, jv) = jattn.attention_decode_paged_deferred(jp, jcfg, jnp.asarray(x), jc)
    t_out, (tk, tv) = tattn.attention_decode_paged_deferred(tp, tcfg, torch.from_numpy(x), tc)
    assert np.abs(t_out.numpy() - np.asarray(j_out)).max() <= TOL
    assert np.abs(tk.numpy() - np.asarray(jk)).max() <= TOL and np.abs(tv.numpy() - np.asarray(jv)).max() <= TOL


def test_self_kv_checks_its_rows():
    cache = tpaged.init_paged_cache(num_pages=3, num_slots=2, pages_per_slot=1, kv_heads=2, page_size=128,
                                    head_dim=32, dtype=torch.float32, device="cpu")
    q = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="self_kv"):
        tpaged.paged_decode_attention(q, cache, self_kv=(torch.zeros(2, 4, 32), torch.zeros(2, 4, 32)))
    # A slot of length 0 attends only its own row: the output is v_new, and the LSE the score.
    k_new, v_new = torch.randn(2, 2, 32), torch.randn(2, 2, 32)
    out, lse = tpaged.paged_decode_attention(q + 1, cache, save_residuals=True, self_kv=(k_new, v_new))
    assert torch.equal(out, v_new.repeat_interleave(2, dim=1))
    score = (k_new.sum(-1) * 32**-0.5 * 1.4426950408889634).repeat_interleave(2, dim=1)
    assert torch.allclose(lse, score, rtol=0, atol=1e-5)
