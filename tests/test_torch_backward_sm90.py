"""The Python side of K4 and K5's tensor-core bodies (csrc/flash_bwd_sm90.cu).

What the CPU can hold of them: the split count K5 takes (a pure function of
the shapes and the SM count), the operands the wrapper hands to TMA (only
misaligned ones are copied), the padded lse / delta rows, the split sum's
plain version, and the gradients of ``flash_attention`` against ``jax.grad``
of the JAX package's (its Pallas backward in interpret mode on the CPU) at
lengths across the bodies' 64- and 128-row tile edges and at GQA group 8.
The kernels themselves run only on the card (chip_smoke.py phases 12 and
18).

Tolerances: fp32 port against JAX 1e-4, as tests/test_torch_backward.py
(the same math, summed in another order); the split sum's plain version
against numpy's sequential fp32 sum exactly (the same additions in the same
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu_torch.ops import attention_bwd
from flash_attention_tpu_torch.ops.attention_bwd import (
    DKV_TILE,
    ROW_PAD,
    _padded_rows,
    dkv_split_sum_plain,
    dkv_splits,
    launch_dkv_sum,
    tma_aligned,
    tma_operands,
)
from flash_attention_tpu_torch.ops.flash_attention import flash_attention

FP32_TOL = 1e-4
H100_SMS = 132


@pytest.mark.parametrize(
    "batch,num_kv_heads,kv_len,group,num_sms",
    [
        (1, 8, 2048, 4, H100_SMS),
        (1, 8, 8192, 4, H100_SMS),
        (1, 8, 4096, 4, H100_SMS),
        (2, 8, 1100, 8, H100_SMS),
        (1, 8, 1100, 8, H100_SMS),
        (1, 2, 300, 4, H100_SMS),
        (1, 1, 127, 8, H100_SMS),
        (4, 32, 2048, 1, H100_SMS),
        (1, 4, 1000, 6, 16),
        (3, 2, 700, 12, 40),
    ],
)
def test_dkv_splits_is_the_smallest_divisor_filling_the_card(batch, num_kv_heads, kv_len, group, num_sms):
    splits = dkv_splits(batch, num_kv_heads, kv_len, group, num_sms)
    blocks = -(-kv_len // DKV_TILE) * batch * num_kv_heads
    assert group % splits == 0
    smaller = [s for s in range(1, splits) if group % s == 0]
    assert all(blocks * s < 2 * num_sms for s in smaller), "a smaller divisor already gives two blocks an SM"
    if splits < group:
        assert blocks * splits >= 2 * num_sms


@pytest.mark.parametrize(
    "kv_len,want", [(2048, 4), (8192, 1), (4096, 2), (256, 4)], ids=["T2048", "T8192-mistral", "T4096", "q256"]
)
def test_dkv_splits_at_the_training_shapes(kv_len, want):
    """ModelConfig() (8 kv heads, group 4) on an H100: T=2048 splits the
    group in 4 (16 x 8 = 128 blocks alone), Mistral's T=8192 not at all
    (64 x 8 = 512 blocks)."""
    assert dkv_splits(1, 8, kv_len, 4, H100_SMS) == want


def test_dkv_splits_of_mha_is_one():
    assert dkv_splits(1, 1, 64, 1, H100_SMS) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tma_operands_copies_exactly_the_misaligned(dtype):
    batch, heads, seq, d = 1, 4, 100, 32
    contiguous = torch.randn(batch, heads, seq, d).to(dtype)
    # The cotangent through the output projection: a [B, S, H, D] buffer
    # seen as [B, H, S, D], strided heads and rows of 16-byte multiples.
    strided_do = torch.randn(batch, seq, heads, d).to(dtype).transpose(1, 2)
    base = torch.randn(2 * contiguous.numel()).to(dtype)
    shifted = base[1 : 1 + contiguous.numel()].view(contiguous.shape)  # base 2 bytes off
    wide = torch.randn(batch, heads, seq, d + 4).to(dtype)[..., :d]  # rows 72 bytes apart
    one_row = torch.randn(batch, heads, 8, d + 4).to(dtype)[:, :, :1, :d]  # a 72-byte row stride never stepped
    tensors = [contiguous, strided_do, shifted, wide, one_row]
    assert [tma_aligned(x) for x in tensors] == [True, True, False, False, True]
    out = tma_operands(*tensors)
    for x, y, copied in zip(tensors, out, [False, False, True, True, False]):
        assert (y is not x) == copied
        assert torch.equal(y, x)
        assert tma_aligned(y)


def test_padded_rows_pads_to_64_with_zeros():
    lse = torch.randn(2, 3, 129)
    padded = _padded_rows(lse)
    assert padded.shape == (2, 3, 192) and padded.shape[-1] % ROW_PAD == 0
    assert torch.equal(padded[..., :129], lse) and bool((padded[..., 129:] == 0).all())
    aligned = torch.randn(2, 3, 128)
    assert _padded_rows(aligned) is aligned


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_sum_plain_adds_the_splits_in_order(splits, dtype):
    rng = np.random.default_rng(splits)
    ws = rng.normal(size=(2, 1, 2, splits, 70, 32)).astype(np.float32) * 10.0 ** rng.integers(-3, 3, (splits, 1, 1))
    want = ws[:, :, :, 0].copy()
    for s in range(1, splits):
        want = want + ws[:, :, :, s]  # fp32 in numpy, one split at a time
    dk, dv = dkv_split_sum_plain(torch.from_numpy(ws), dtype)
    assert dk.dtype == dtype and dk.shape == (1, 2, 70, 32)
    assert torch.equal(dk, torch.from_numpy(want[0]).to(dtype))
    assert torch.equal(dv, torch.from_numpy(want[1]).to(dtype))


def test_split_sum_wrapper_refuses_cpu_tensors():
    ws = torch.zeros(2, 1, 1, 2, 8, 32)
    dk = torch.empty(1, 1, 8, 32, dtype=torch.bfloat16)
    before = launch_dkv_sum.launches
    with pytest.raises(ValueError, match="cuda"):
        launch_dkv_sum(ws, dk, dk.clone())
    assert launch_dkv_sum.launches == before


def test_cpu_half_precision_backward_launches_nothing():
    """A bf16 CPU call takes the plain version: no kernel is counted."""
    q = torch.randn(1, 8, 129, 32).to(torch.bfloat16).requires_grad_()
    k = torch.randn(1, 1, 129, 32).to(torch.bfloat16).requires_grad_()
    v = torch.randn(1, 1, 129, 32).to(torch.bfloat16).requires_grad_()
    counts = [attention_bwd.launch_dq.launches, attention_bwd.launch_dkv.launches, launch_dkv_sum.launches]
    grads = torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), torch.ones(1, 8, 129, 32))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    assert [attention_bwd.launch_dq.launches, attention_bwd.launch_dkv.launches, launch_dkv_sum.launches] == counts


def _grads_torch(arrays, do, causal):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return torch.autograd.grad(flash_attention(*leaves, causal=causal), leaves, torch.from_numpy(do))


def _grads_jax(arrays, do, causal):
    w = jnp.asarray(do)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))


# hq, hkv, q_len, kv_len, causal: across the 64-row (K5's q step, K4's kv
# step) and 128-row (K4's q tile, K5's kv tile) edges, at GQA group 8 and 4.
@pytest.mark.parametrize(
    "hq,hkv,q_len,kv_len,causal",
    [
        pytest.param(8, 1, 127, 127, True, id="gqa8-127"),
        pytest.param(8, 1, 129, 129, True, id="gqa8-129"),
        pytest.param(8, 1, 257, 257, True, id="gqa8-257"),
        pytest.param(8, 2, 129, 257, True, id="gqa4-q129-over-kv257"),
        pytest.param(8, 1, 127, 129, False, id="gqa8-noncausal-127-129"),
    ],
)
def test_grads_match_jax_across_tile_edges(hq, hkv, q_len, kv_len, causal):
    rng = np.random.default_rng(q_len + kv_len)
    q = rng.uniform(-0.5, 0.5, (1, hq, q_len, 32)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (1, hkv, kv_len, 32)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (1, hkv, kv_len, 32)).astype(np.float32)
    do = rng.normal(size=(1, hq, q_len, 32)).astype(np.float32)
    got = _grads_torch((q, k, v), do, causal)
    want = _grads_jax((q, k, v), do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= FP32_TOL, name
