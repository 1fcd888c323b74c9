"""Parity of the port's masked attention backward with the JAX package.

Sliding window, logit softcap and packed-sequence segment ids under grad.
The same inputs and cotangent, made with numpy from a seed, go through
``jax.grad`` of the JAX ``flash_attention`` (its Pallas kernels in
interpret mode, at S <= 256 with 128-row blocks) or, at larger shapes, of
JAX's ``reference_attention``, and through ``torch.autograd.grad`` of the
port's ``flash_attention``, whose autograd Function runs the plain forward
and ``flash_attention_bwd_plain`` for CPU tensors (the card runs K1, K1d or
K2 and the masked K3, or K4 + K5, in the same wiring; chip_smoke.py checks
those).

Tolerances: fp32 gradients within 1e-4 of JAX's (the same math summed in
another order); the plain backward within 1e-5 of autograd through the plain
forward (the same function differentiated two ways).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu.ops.reference import reference_attention as jax_reference_attention
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu_torch.ops.attention_bwd import bwd_route, flash_attention_bwd_plain
from flash_attention_tpu_torch.ops.common import segment_tile_ranges
from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

FP32_TOL = 1e-4
PLAIN_TOL = 1e-5
BLOCKS = BlockSizes(block_q=128, block_kv=128)


def _inputs(seed, batch, hq, hkv, q_len, kv_len, d, q_scale=1.0):
    """fp32 numpy q, k, v ~ U(-0.5, 0.5) (q times ``q_scale``, so a softcap
    bites) and a cotangent ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-0.5, 0.5, (batch, hq, q_len, d)) * q_scale).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (batch, hkv, kv_len, d)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (batch, hkv, kv_len, d)).astype(np.float32)
    do = rng.normal(size=(batch, hq, q_len, d)).astype(np.float32)
    return q, k, v, do


def _segments(batch, seq, boundaries):
    """Segment ids [batch, seq] int32 splitting each row at ``boundaries``
    (the JAX tests' make_segments)."""
    ids = np.zeros((batch, seq), np.int32)
    for i, cut in enumerate(boundaries):
        ids[:, cut:] = i + 1
    return ids


def _to(ids, convert):
    if ids is None:
        return None
    return tuple(convert(x) for x in ids) if isinstance(ids, tuple) else convert(ids)


def _torch_grads(fn, arrays, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(do))


def _jax_grads(fn, arrays, do):
    w = jnp.asarray(do)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))


def _diff(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max())


def _port(causal, masks):
    ids = _to(masks.get("segment_ids"), torch.from_numpy)
    kw = dict(causal=causal, sliding_window=masks.get("window"), logit_softcap=masks.get("cap"), segment_ids=ids)
    return lambda q, k, v: flash_attention(q, k, v, **kw)


def _jax_kernel(causal, masks):
    ids = _to(masks.get("segment_ids"), jnp.asarray)
    kw = dict(causal=causal, sliding_window=masks.get("window"), logit_softcap=masks.get("cap"), segment_ids=ids)
    return lambda q, k, v: jax_flash_attention(q, k, v, block_sizes=BLOCKS, bwd_block_sizes=BLOCKS, **kw)


def _jax_oracle(causal, masks):
    ids = _to(masks.get("segment_ids"), jnp.asarray)
    kw = dict(causal=causal, sliding_window=masks.get("window"), logit_softcap=masks.get("cap"), segment_ids=ids)
    return lambda q, k, v: jax_reference_attention(q, k, v, out_dtype=jnp.float32, **kw)


KERNEL_CASES = [
    # tests/test_window_softcap.py:101-151 (at S 256 for the interpreter's budget)
    pytest.param(1, 2, 2, 256, 256, 32, dict(window=64), 1.0, id="window64-mha"),
    pytest.param(1, 2, 2, 256, 256, 32, dict(window=100), 1.0, id="window100-mha"),
    pytest.param(1, 2, 2, 256, 256, 32, dict(cap=1.0), 8.0, id="softcap1-q8"),
    pytest.param(1, 2, 2, 256, 256, 32, dict(window=96, cap=2.0), 8.0, id="window96-softcap2-q8"),
    pytest.param(1, 2, 2, 128, 256, 32, dict(window=200), 1.0, id="window200-q-shorter"),
    # tests/test_segments.py:30-131
    pytest.param(2, 4, 4, 256, 256, 32, dict(segment_ids=_segments(2, 256, [100, 180])), 1.0, id="segments-mha"),
    pytest.param(2, 8, 2, 256, 256, 32, dict(segment_ids=_segments(2, 256, [128]), cap=30.0), 1.0,
                 id="segments-gqa-softcap30"),
    # tests/test_backward.py:137, :206
    pytest.param(1, 2, 2, 256, 256, 32, dict(cap=20.0), 8.0, id="softcap20-q8"),
    pytest.param(1, 2, 2, 256, 256, 32, dict(window=200), 1.0, id="window200"),
    pytest.param(1, 2, 2, 256, 256, 32, dict(window=300, cap=15.0), 8.0, id="window300-softcap15-q8"),
    # all three together, GQA (K4 + K5 on the card) and MHA (K3)
    pytest.param(1, 4, 2, 256, 256, 32, dict(window=90, cap=5.0, segment_ids=_segments(1, 256, [70, 200])), 4.0,
                 id="all-three-gqa"),
    pytest.param(1, 2, 2, 256, 256, 32, dict(window=90, cap=5.0, segment_ids=_segments(1, 256, [70, 200])), 4.0,
                 id="all-three-mha"),
]


@pytest.mark.parametrize("batch,hq,hkv,q_len,kv_len,d,masks,q_scale", KERNEL_CASES)
def test_masked_grads_match_jax_kernels(batch, hq, hkv, q_len, kv_len, d, masks, q_scale):
    q, k, v, do = _inputs(len(masks) + q_len, batch, hq, hkv, q_len, kv_len, d, q_scale)
    got = _torch_grads(_port(True, masks), (q, k, v), do)
    want = _jax_grads(_jax_kernel(True, masks), (q, k, v), do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _diff(g, w) <= FP32_TOL, name


@pytest.mark.parametrize("causal", [False, True])
def test_segment_grads_noncausal_and_causal_match_jax(causal):
    """tests/test_segments.py:30 and :109: segments with and without the
    causal mask."""
    q, k, v, do = _inputs(35, 1, 2, 2, 256, 256, 32)
    masks = dict(segment_ids=_segments(1, 256, [150]))
    got = _torch_grads(_port(causal, masks), (q, k, v), do)
    want = _jax_grads(_jax_kernel(causal, masks), (q, k, v), do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _diff(g, w) <= FP32_TOL, name


ORACLE_CASES = [
    pytest.param(1, 8, 2, 640, 640, 64, dict(window=300, cap=30.0), 8.0, id="gqa-window-softcap"),
    pytest.param(2, 4, 4, 512, 512, 32, dict(segment_ids=_segments(2, 512, [77, 300, 301])), 1.0,
                 id="mha-segments-one-row-doc"),
    pytest.param(1, 4, 1, 300, 700, 32, dict(window=333, segment_ids=(_segments(1, 700, [500])[:, -300:],
                                                                       _segments(1, 700, [500]))), 1.0,
                 id="mqa-cross-pair-window"),
]


@pytest.mark.parametrize("batch,hq,hkv,q_len,kv_len,d,masks,q_scale", ORACLE_CASES)
def test_masked_grads_match_jax_oracle_at_larger_shapes(batch, hq, hkv, q_len, kv_len, d, masks, q_scale):
    """Past the interpreter's budget: against jax.grad of JAX's fp32
    reference_attention under the same masks."""
    q, k, v, do = _inputs(7 + q_len, batch, hq, hkv, q_len, kv_len, d, q_scale)
    got = _torch_grads(_port(True, masks), (q, k, v), do)
    want = _jax_grads(_jax_oracle(True, masks), (q, k, v), do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _diff(g, w) <= FP32_TOL, name


@pytest.mark.parametrize("causal", [False, True])
def test_dead_segment_rows_give_finite_zero_grads(causal):
    """tests/test_segments.py:362: q rows whose id no kv row carries get
    output 0, LSE -inf and exactly zero gradient; the rest match JAX."""
    q, k, v, do = _inputs(13, 1, 2, 2, 128, 128, 32)
    q_ids = np.concatenate([np.zeros((1, 64), np.int32), np.full((1, 64), 2, np.int32)], axis=1)
    masks = dict(segment_ids=(q_ids, np.zeros((1, 128), np.int32)))
    got = _torch_grads(_port(causal, masks), (q, k, v), do)
    want = _jax_grads(_jax_kernel(causal, masks), (q, k, v), do)
    assert bool((got[0][:, :, 64:] == 0).all())
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _diff(g, w) <= FP32_TOL, name
    with torch.no_grad():
        out, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, save_residuals=True,
                                   segment_ids=_to(masks["segment_ids"], torch.from_numpy))
    assert bool((out[:, :, 64:] == 0).all()) and bool(torch.isneginf(lse[:, :, 64:]).all())


def test_packed_grads_equal_documents_one_by_one():
    """tests/test_segments.py:70: a packed row's output and gradients equal
    each document attended alone, with the window."""
    q, k, v, do = _inputs(34, 1, 2, 2, 200, 200, 32)
    cut = 120
    packed = _torch_grads(_port(True, dict(segment_ids=_segments(1, 200, [cut]), window=50)), (q, k, v), do)
    for lo, hi in ((0, cut), (cut, 200)):
        part = [a[:, :, lo:hi].copy() for a in (q, k, v, do)]
        alone = _torch_grads(_port(True, dict(window=50)), part[:3], part[3])
        for g, w in zip(packed, alone):
            assert _diff(g[:, :, lo:hi], w.detach().numpy()) <= PLAIN_TOL


MASKS = [
    pytest.param(dict(window=7), id="window"),
    pytest.param(dict(cap=0.4), id="softcap"),
    pytest.param(dict(segment_ids=(_segments(2, 96, [30, 31, 70]), _segments(2, 96, [30, 31, 70]))), id="segments"),
    pytest.param(dict(window=20, cap=0.4, segment_ids=(_segments(2, 96, [50]), _segments(2, 96, [50]))), id="all"),
]


@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("hq,hkv,q_len,kv_len", [(4, 4, 96, 96), (4, 2, 96, 96), (6, 2, 40, 96)])
def test_plain_backward_matches_autograd_of_plain_forward(masks, hq, hkv, q_len, kv_len):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 2, hq, hkv, q_len, kv_len, 32, 4.0))
    segments = masks.get("segment_ids")
    if segments is not None:
        segments = (torch.from_numpy(segments[0][:, -q_len:].copy()), torch.from_numpy(segments[1]))
    fwd = dict(sliding_window=masks.get("window"), logit_softcap=masks.get("cap"), segments=segments)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, causal=True, sm_scale=0.2, save_residuals=False, **fwd),
                               leaves, do)
    out, lse = flash_attention_plain(q, k, v, causal=True, sm_scale=0.2, save_residuals=True, **fwd)
    got = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True, sm_scale=0.2, window=masks.get("window"),
                                    softcap=masks.get("cap"), segments=segments)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _diff(g, w.numpy()) <= PLAIN_TOL


@pytest.mark.parametrize("window,cap", [(None, None), (40, None), (None, 0.5), (40, 0.5)])
def test_fused_route_equals_two_pass_route(window, cap):
    """K3's route (MHA self-attention) against K4 + K5's on the same
    gradient: the kv sequence is lengthened in front by rows of an id no
    query carries, which makes the call cross-length (the two-pass route)
    without changing what any query sees; the new rows get zero gradient."""
    q, k, v, do = _inputs(9, 1, 4, 4, 128, 160, 32, 4.0)
    ids = _segments(1, 160, [32, 100])  # kv rows [0, 32) carry id 0, which no query has
    assert bwd_route(4, 4, 128, 128) == "fused" and bwd_route(4, 4, 128, 160) == "two_pass"
    fused = _torch_grads(_port(True, dict(window=window, cap=cap, segment_ids=ids[:, 32:].copy())),
                         (q, k[:, :, 32:].copy(), v[:, :, 32:].copy()), do)
    two_pass = _torch_grads(_port(True, dict(window=window, cap=cap, segment_ids=(ids[:, 32:].copy(), ids))),
                            (q, k, v), do)
    assert _diff(two_pass[0], fused[0].numpy()) <= PLAIN_TOL
    for g2, g1 in zip(two_pass[1:], fused[1:]):
        assert bool((g2[:, :, :32] == 0).all())
        assert _diff(g2[:, :, 32:], g1.numpy()) <= PLAIN_TOL


BAD_SEGMENTS = [
    pytest.param(128, 128, lambda: np.zeros((1, 64), np.int32), id="short-single"),
    pytest.param(64, 128, lambda: np.zeros((1, 128), np.int32), id="single-cross-length"),
    pytest.param(64, 128, lambda: (np.zeros((1, 128), np.int32), np.zeros((1, 128), np.int32)), id="q-ids-shape"),
    pytest.param(64, 128, lambda: (np.zeros((1, 64), np.int32), np.zeros((2, 128), np.int32)), id="kv-ids-shape"),
]


@pytest.mark.parametrize("q_len,kv_len,make", BAD_SEGMENTS)
def test_segment_validation_errors_match_jax(q_len, kv_len, make):
    q, k, v, _ = _inputs(36, 1, 2, 2, q_len, kv_len, 32)
    with pytest.raises(ValueError) as jax_err:
        jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, segment_ids=_to(make(), jnp.asarray))
    with pytest.raises(ValueError) as port_err:
        flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, segment_ids=_to(make(), torch.from_numpy))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_reference_segment_ids_and_out_dtype_match_jax(pair):
    q, k, v, _ = _inputs(40, 2, 4, 2, 96 if pair else 160, 160, 32)
    kv_ids = _segments(2, 160, [60, 61, 120])
    ids = (kv_ids[:, -96:].copy(), kv_ids) if pair else kv_ids
    for causal, window in ((False, None), (True, None), (True, 50)):
        want = jax_reference_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
                                       sliding_window=window, segment_ids=_to(ids, jnp.asarray), out_dtype=jnp.float32)
        bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
        got = reference_attention(*bf16, causal=causal, sliding_window=window, segment_ids=_to(ids, torch.from_numpy),
                                  out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert _diff(got, want) <= FP32_TOL
        out, lse = reference_attention_with_lse(*bf16, causal=causal, sliding_window=window,
                                                segment_ids=_to(ids, torch.from_numpy), out_dtype=torch.float32)
        assert out.dtype == torch.float32 and _diff(out, want) <= FP32_TOL
        assert bool(torch.isfinite(lse).all())


def test_segment_tile_ranges_cover_each_tile():
    """The kernels' skip reads each 64-row tile's [min, max] id; the ragged
    last tile repeats its last id, so padding widens no range."""
    ids = torch.tensor([[0] * 64 + [0] * 10 + [1] * 60 + [3] * 6, [5] * 70 + [2] * 70])
    ranges = segment_tile_ranges(ids)
    assert ranges.dtype == torch.int32 and ranges.shape == (2, 3, 2)
    assert ranges[0].tolist() == [[0, 0], [0, 1], [1, 3]]
    assert ranges[1].tolist() == [[5, 5], [2, 5], [2, 2]]
