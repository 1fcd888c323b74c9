"""Parity of the PyTorch port's masked attention-layer steps with the JAX package.

Chunked prefill and decode through the rolling ring cache (with sinks, and
with a softcap) in the attention layer, against the JAX layer on the same
parameters (``params_from_jax``) and numpy-seeded inputs. On the JAX side
attention runs through the Pallas kernels in interpret mode, on the port's
side through the plain versions. The paged layer steps are in
tests/test_torch_masks_paged_layer.py.

Tolerances: layer outputs and cache rows 1e-4 (fp32, summation order
only); cache lengths equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models.convert import params_from_jax

OP_TOL = 1e-4
ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")


def _diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


def _assert_caches_close(tc, jc):
    """K/V rows within OP_TOL (the two packages' projections differ in the
    last place) and lengths equal."""
    for name in ("k", "v", "k_scales", "v_scales"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert (t is None) == (j is None), name
        assert t is None or _diff(t, j) <= OP_TOL, name
    assert np.array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


# ---------------------------------------------------------------- the layer


@pytest.mark.parametrize("sinks,cap", [(0, None), (32, None), (0, 5.0)])
def test_rolling_chunks_and_decode_match_jax(sinks, cap):
    """Chunked prefill through the ring (chunks wrap its end; with sinks,
    the band and sink passes merged past the window), then decode steps
    past several wraps: outputs and caches equal to the JAX layer's."""
    fields = dict(sliding_window=192 if sinks else 96, rolling=True, attention_sinks=sinks, logit_softcap=cap)
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    jp = jattn.init_attention_params(jax.random.key(2), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    chunk, total = 64, 384
    jc = jattn.init_kv_cache(jcfg, 1, 2048, prefill_chunk=chunk)
    tc = tattn.init_kv_cache(tcfg, 1, 2048, device="cpu", prefill_chunk=chunk)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(1, total, 64)).astype(np.float32) * (4.0 if cap else 1.0)
    for c in range(total // chunk):
        x = xs[:, c * chunk:(c + 1) * chunk]
        j_out, jc = jattn.attention_prefill_chunk(jp, jcfg, jnp.asarray(x), jc, 0, c * chunk, (c + 1) * chunk)
        t_out, tc = tattn.attention_prefill_chunk(tp, tcfg, torch.from_numpy(x), tc, 0, c * chunk, (c + 1) * chunk)
        assert _diff(t_out, j_out) <= OP_TOL, f"chunk {c}"
    _assert_caches_close(tc, jc)
    for step in range(3):
        x = rng.normal(size=(1, 1, 64)).astype(np.float32)
        j_out, jc = jattn.attention_decode(jp, jcfg, jnp.asarray(x), jc)
        t_out, tc = tattn.attention_decode(tp, tcfg, torch.from_numpy(x), tc)
        assert _diff(t_out, j_out) <= OP_TOL, f"decode {step}"
    _assert_caches_close(tc, jc)
