"""Parity of the PyTorch port's attention backward with the JAX package.

The same inputs and cotangent, made with numpy from a seed, go through
``jax.grad`` of the JAX ``flash_attention`` (its Pallas backward kernels in
interpret mode on the CPU, as the JAX package's own tests run them) and
through ``torch.autograd.grad`` of the port's ``flash_attention``, whose
autograd Function runs the plain forward and ``flash_attention_bwd_plain``
for CPU tensors. The CUDA kernels K3, K4 and K5 are checked on the card by
chip_smoke.py.

Tolerances:
  * the plain backward against autograd through the plain forward: 1e-5
    (fp32, the same function differentiated two ways);
  * fp32 port against JAX: 1e-4 (the same math, summed in another order);
  * bf16: each side within the reference bar 0.1 of autograd through the
    fp32 oracle, and port against JAX within 3e-2, two bf16 steps of
    gradients in [2, 4): the JAX kernels round P and dS to bf16 before
    their products and the port keeps them in fp32, so the two round the
    same gradient from different fp32 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu_torch.ops import attention_bwd
from flash_attention_tpu_torch.ops.attention_bwd import bwd_route, flash_attention_bwd, flash_attention_bwd_plain
from flash_attention_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_plain,
)
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.utils.testing import REFERENCE_TOLERANCE

PLAIN_TOL = 1e-5
FP32_TOL = 1e-4
BF16_VS_JAX = 3e-2


def _inputs(seed, batch, hq, hkv, q_len, kv_len, d):
    """fp32 numpy q, k, v ~ U(-0.5, 0.5) and a cotangent ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (batch, hq, q_len, d)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (batch, hkv, kv_len, d)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (batch, hkv, kv_len, d)).astype(np.float32)
    do = rng.normal(size=(batch, hq, q_len, d)).astype(np.float32)
    return q, k, v, do


def _torch_grads(fn, arrays, do, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, torch.from_numpy(do).to(out.dtype))


def _jax_grads(fn, arrays, do, dtype):
    w = jnp.asarray(do)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a).astype(dtype) for a in arrays))


def _diff(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(jnp.asarray(got, jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max())


# batch, hq, hkv, q_len, kv_len, d, causal; the route they take on the card.
CASES = [
    pytest.param(1, 2, 2, 128, 128, 32, True, id="mha-causal-K3"),
    pytest.param(1, 2, 2, 128, 128, 64, False, id="mha-noncausal-K3"),
    pytest.param(2, 4, 2, 64, 64, 32, True, id="gqa2-K4K5"),
    pytest.param(1, 8, 2, 64, 64, 32, False, id="gqa4-noncausal-K4K5"),
    pytest.param(1, 4, 2, 64, 192, 32, True, id="q-shorter-end-aligned-K4K5"),
    pytest.param(1, 2, 2, 100, 100, 32, True, id="ragged-mha-K3"),
    pytest.param(1, 4, 1, 70, 130, 64, True, id="ragged-mqa-cross-K4K5"),
]


@pytest.mark.parametrize("batch,hq,hkv,q_len,kv_len,d,causal", CASES)
def test_grads_match_jax_fp32(batch, hq, hkv, q_len, kv_len, d, causal):
    arrays = _inputs(0, batch, hq, hkv, q_len, kv_len, d)
    q, k, v, do = arrays
    got = _torch_grads(lambda q, k, v: flash_attention(q, k, v, causal=causal), (q, k, v), do, torch.float32)
    want = _jax_grads(lambda q, k, v: jax_flash_attention(q, k, v, causal=causal), (q, k, v), do, "float32")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _diff(g, w) <= FP32_TOL, name


@pytest.mark.parametrize(
    "batch,hq,hkv,q_len,kv_len,d,causal",
    [
        pytest.param(1, 2, 2, 128, 128, 64, True, id="mha-causal-K3"),
        pytest.param(1, 4, 2, 64, 192, 128, True, id="gqa2-q-shorter-K4K5"),
    ],
)
def test_grads_match_jax_bf16(batch, hq, hkv, q_len, kv_len, d, causal):
    arrays = _inputs(1, batch, hq, hkv, q_len, kv_len, d)
    q, k, v, do = arrays
    got = _torch_grads(lambda q, k, v: flash_attention(q, k, v, causal=causal), (q, k, v), do, torch.bfloat16)
    want = _jax_grads(lambda q, k, v: jax_flash_attention(q, k, v, causal=causal), (q, k, v), do, "bfloat16")
    oracle = _torch_grads(
        lambda q, k, v: reference_attention(q, k, v, causal=causal), (q, k, v), do, torch.float32
    )
    for g, w, o, name in zip(got, want, oracle, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, name
        assert _diff(g, o) < REFERENCE_TOLERANCE, name
        assert _diff(w, o) < REFERENCE_TOLERANCE, name
        assert _diff(g, w) <= BF16_VS_JAX, name


@pytest.mark.parametrize(
    "hq,hkv,q_len,kv_len,causal",
    [(4, 4, 96, 96, True), (4, 2, 40, 96, True), (6, 2, 50, 50, False)],
)
def test_plain_backward_matches_autograd_of_plain_forward(hq, hkv, q_len, kv_len, causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 2, hq, hkv, q_len, kv_len, 32))
    scale = 0.2
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=causal, sm_scale=scale, save_residuals=False)
    want = torch.autograd.grad(out, leaves, do)
    out, lse = flash_attention_plain(q, k, v, causal=causal, sm_scale=scale, save_residuals=True)
    got = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, sm_scale=scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _diff(g, w) <= PLAIN_TOL


def test_dead_rows_give_finite_zero_gradient():
    """A row with LSE -inf (it saw no key; its output and cotangent are 0)
    contributes exactly nothing: its lse becomes 0 before P is recomputed,
    so dS = P * (dP - delta) = P * 0, not inf * 0 = NaN."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 2, 16, 16, 32))
    out, lse = flash_attention_plain(q, k, v, causal=False, sm_scale=0.2, save_residuals=True)
    dead = 5
    out[:, :, dead], do[:, :, dead], lse[:, :, dead] = 0.0, 0.0, -torch.inf
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False, sm_scale=0.2)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert bool((dq[:, :, dead] == 0).all())
    # dk and dv equal the gradients of the other rows alone.
    keep = [i for i in range(16) if i != dead]
    _, dk_alive, dv_alive = flash_attention_bwd_plain(
        q[:, :, keep], k, v, out[:, :, keep], lse[:, :, keep], do[:, :, keep], causal=False, sm_scale=0.2
    )
    assert _diff(dk, dk_alive) <= PLAIN_TOL and _diff(dv, dv_alive) <= PLAIN_TOL


@pytest.mark.parametrize(
    "hq,hkv,q_len,kv_len,route",
    [
        (32, 32, 2048, 2048, "fused"),  # MHA self-attention: K3
        (32, 8, 2048, 2048, "two_pass"),  # ModelConfig()'s GQA: K4 + K5
        (32, 32, 256, 2048, "two_pass"),  # MHA, q shorter than kv
        (8, 1, 100, 100, "two_pass"),  # MQA
        (4, 4, 1, 1, "fused"),
    ],
)
def test_route_follows_the_jax_dispatch(hq, hkv, q_len, kv_len, route):
    assert bwd_route(hq, hkv, q_len, kv_len) == route


def test_save_residuals_under_grad_raises():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 2, 8, 8, 32))
    q.requires_grad_()
    with pytest.raises(ValueError, match="not differentiable"):
        flash_attention(q, k, v, save_residuals=True)
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, save_residuals=True)
    assert out.grad_fn is None and lse.shape == (1, 2, 8)


def test_cpu_output_carries_the_autograd_function():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 1, 8, 8, 32))
    out = flash_attention(q, k.requires_grad_(), v, causal=True)
    assert type(out.grad_fn) is FlashAttentionFunction._backward_cls
    # Without grad the forward runs alone, with no graph.
    assert flash_attention(q, k.detach(), v, causal=True).grad_fn is None


def test_backward_options_not_ported_raise():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(6, 1, 2, 2, 8, 8, 32))
    out, lse = flash_attention_plain(q, k, v, causal=True, sm_scale=0.2, save_residuals=True)
    for option in ({"window": 4}, {"softcap": 30.0}, {"segments": (torch.zeros(1, 8), torch.zeros(1, 8))}):
        with pytest.raises(NotImplementedError, match="item 3"):
            flash_attention_bwd(q, k, v, out, lse, do, causal=True, sm_scale=0.2, **option)


def test_backward_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a card is neither computed plainly
    nor moved: the wrapper raises, and the launchers count nothing."""
    x = torch.zeros((1, 2, 4, 32), device="meta")
    lse = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_bwd(x, x, x, x, lse, x, causal=True, sm_scale=0.2)
    counts = [attention_bwd.launch_fused.launches, attention_bwd.launch_dq.launches, attention_bwd.launch_dkv.launches]
    assert counts == [0, 0, 0]
