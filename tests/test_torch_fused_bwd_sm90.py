"""The Python side of K3's tensor-core body (csrc/flash_bwd_sm90.cu, the
fused MHA backward).

What the CPU can hold of it: the function it computes, the gradients of
``flash_attention`` on the K3 route (MHA self-attention, its plain backward
on the CPU) against ``jax.grad`` of the JAX package's ``flash_attention``
(its Pallas backward in interpret mode) at lengths across the body's 64-
and 128-row tile edges, causal and not, with window / softcap / segment-id
masks; the route (still K3 for MHA self-attention); the lse and delta rows
the wrapper hands it (padded to 64 in bf16 / fp16); that a bf16 / fp16 call
on the CPU launches nothing and a CPU tensor is refused by the launcher.
The kernel itself runs only on the card (chip_smoke.py phases 12 and 18).

Tolerances: fp32 gradients against JAX 1e-4 (the same math summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu_torch.ops import attention_bwd
from flash_attention_tpu_torch.ops.attention_bwd import (
    ROW_PAD,
    _delta,
    _guard_lse,
    _tensor_core_args,
    bwd_route,
    launch_fused,
)
from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

FP32_TOL = 1e-4
D = 32


def _inputs(seed, heads, seq, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-0.5, 0.5, (1, heads, seq, D)) * q_scale).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (1, heads, seq, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (1, heads, seq, D)).astype(np.float32)
    do = rng.normal(size=(1, heads, seq, D)).astype(np.float32)
    return q, k, v, do


def _docs(seq, cuts):
    ids = np.zeros((1, seq), np.int32)
    for i, cut in enumerate(cuts):
        ids[:, cut:] = i + 1
    return ids


# seq, causal, masks: MHA self-attention (the K3 route) either side of the
# 64-row q steps and the 128-row kv tiles.
EDGE_CASES = [
    pytest.param(63, True, {}, id="63"),
    pytest.param(64, True, {}, id="64"),
    pytest.param(65, True, {}, id="65"),
    pytest.param(127, True, {}, id="127"),
    pytest.param(128, True, {}, id="128"),
    pytest.param(129, True, {}, id="129"),
    pytest.param(255, True, {}, id="255"),
    pytest.param(257, True, {}, id="257"),
    pytest.param(129, False, {}, id="noncausal-129"),
    pytest.param(257, False, {}, id="noncausal-257"),
    pytest.param(257, True, dict(sliding_window=65), id="257-window65"),
    pytest.param(255, True, dict(sliding_window=63, logit_softcap=5.0), id="255-window63-softcap"),
    pytest.param(129, True, dict(logit_softcap=2.0), id="129-softcap"),
    pytest.param(257, True, dict(segment_ids=(100, 190)), id="257-documents"),
    pytest.param(255, True, dict(sliding_window=100, segment_ids=(64, 129)), id="255-window-documents"),
]


@pytest.mark.parametrize("seq,causal,masks", EDGE_CASES)
def test_mha_grads_match_jax_across_tile_edges(seq, causal, masks):
    masks = dict(masks)
    assert bwd_route(2, 2, seq, seq) == "fused"
    q, k, v, do = _inputs(seq + (0 if causal else 7), 2, seq, 8.0 if "logit_softcap" in masks else 1.0)
    cuts = masks.pop("segment_ids", None)
    ids = None if cuts is None else _docs(seq, cuts)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    t_ids = None if ids is None else torch.from_numpy(ids)
    got = torch.autograd.grad(flash_attention(*leaves, causal=causal, segment_ids=t_ids, **masks), leaves,
                              torch.from_numpy(do))
    w, j_ids = jnp.asarray(do), None if ids is None else jnp.asarray(ids)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal, segment_ids=j_ids, **masks) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w_, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w_.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float(np.abs(g.numpy() - np.asarray(w_)).max()) <= FP32_TOL, name


@pytest.mark.parametrize(
    "hq,hkv,q_len,kv_len,want",
    [(32, 32, 2048, 2048, "fused"), (32, 32, 8192, 8192, "fused"), (32, 8, 2048, 2048, "two_pass"),
     (32, 32, 256, 2048, "two_pass")],
    ids=["phase14-mha", "phase20d-mha", "gqa", "cross-length"],
)
def test_mha_self_attention_stays_on_k3(hq, hkv, q_len, kv_len, want):
    """Phase 14's MHA step and phase 20d launch K3 (K3m), not K4 + K5."""
    assert bwd_route(hq, hkv, q_len, kv_len) == want


@pytest.mark.parametrize("dtype,pitch", [(torch.bfloat16, 192), (torch.float16, 192), (torch.float32, 129)])
def test_fused_launch_gets_padded_rows_in_half_precision(dtype, pitch):
    """K3's tensor-core body reads lse and delta 64 rows at a time (rows
    padded with 0 to a multiple of ROW_PAD); the fp32 FMA body reads them
    as they are."""
    q = torch.randn(1, 2, 129, D).to(dtype)
    lse, delta = torch.randn(1, 2, 129), torch.randn(1, 2, 129)
    args, got_pitch = _tensor_core_args(q, q, q, q, lse, delta)
    assert got_pitch == pitch
    if dtype != torch.float32:
        assert got_pitch % ROW_PAD == 0 and args[4].shape[-1] == pitch
        assert torch.equal(args[4][..., :129], lse) and bool((args[4][..., 129:] == 0).all())
    else:
        assert args[4] is lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("masks", [{}, dict(sliding_window=90, logit_softcap=5.0)], ids=["plain", "masked"])
def test_cpu_half_precision_mha_backward_launches_nothing(dtype, masks):
    """A CPU call on the K3 route takes the plain versions: no kernel is
    counted."""
    leaves = [torch.randn(1, 4, 129, D).to(dtype).requires_grad_() for _ in range(3)]
    counts = [launch_fused.launches, launch_fused.masked_launches, attention_bwd.launch_dq.launches]
    grads = torch.autograd.grad(flash_attention(*leaves, causal=True, **masks), leaves, torch.ones(1, 4, 129, D))
    assert all(g.dtype == dtype and bool(torch.isfinite(g.float()).all()) for g in grads)
    assert [launch_fused.launches, launch_fused.masked_launches, attention_bwd.launch_dq.launches] == counts


def test_fused_launcher_refuses_cpu_tensors():
    q = torch.randn(1, 2, 64, D).to(torch.bfloat16)
    out, lse = flash_attention_plain(q, q, q, causal=True, sm_scale=D**-0.5, save_residuals=True)
    before = launch_fused.launches
    with pytest.raises(ValueError, match="cuda"):
        launch_fused(q, q, q, q, _guard_lse(lse), _delta(out, q), causal=True, sm_scale=D**-0.5)
    assert launch_fused.launches == before
