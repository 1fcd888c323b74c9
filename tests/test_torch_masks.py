"""Parity of the PyTorch port's masked attention ops with the JAX package.

Sliding window, logit softcap, the rolling ring-buffer decode cache and
StreamingLLM attention sinks. The same inputs, made with numpy from a seed,
go through the JAX function (its Pallas kernels in interpret mode, as the
JAX package's tests/test_window_softcap.py and tests/test_rolling.py run
them) and through the port's counterpart (its plain PyTorch version, which
the port runs for CPU tensors). The CUDA kernels themselves are held on the
card by chip_smoke.py (phase 15).

Tolerances:
  * fp32: 1e-4 on outputs and base-2 LSE (the same math summed in another
    order; tanh evaluated by two libraries);
  * bf16: 1.5e-2 (the JAX kernels round P to bf16 before P·V while the port
    keeps P in fp32), as tests/test_torch_ops.py;
  * quantized caches: 1e-4 (fp32 queries; the port scales each row as it
    loads it, JAX scales the scores and p).
Queries are scaled by 8 where a softcap is on, so the scores reach the cap
and tanh is far from the identity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import decode as jdecode
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu.ops.reference import reference_attention as jax_reference_attention
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax
from flash_attention_tpu_torch.ops import decode as tdecode
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops import quant as tquant
from flash_attention_tpu_torch.ops.flash_attention import BAND_MAX_WINDOW, flash_attention
from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

FP32_TOL = 1e-4
BF16_TOL = 1.5e-2
TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}
PAGE = 128
D = 32


def _uniform(rng, shape, scale=1.0):
    return (rng.uniform(-0.5, 0.5, shape) * scale).astype(np.float32)


def _both(a: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _diff(got: torch.Tensor, want) -> float:
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), "non-finite entries differ"
    assert np.array_equal(got[~fin], want[~fin]), "non-finite entries differ"
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


# ---------------------------------------------------------------- flash_attention


@pytest.mark.parametrize(
    "hq,hkv,sq,skv,window,cap,dtype",
    [
        (4, 4, 128, 128, 64, None, "float32"),  # the port's K2 band (window <= 64)
        (4, 4, 128, 128, 1, None, "float32"),  # window 1: each row sees itself
        (4, 2, 64, 192, 100, None, "float32"),  # GQA, Sq < Skv end-aligned
        (4, 2, 64, 192, None, 5.0, "float32"),  # softcap alone
        (4, 2, 64, 192, 70, 5.0, "float32"),  # both
        (4, 1, 100, 130, 300, None, "float32"),  # a window wider than the kv
        (4, 2, 64, 192, 100, 5.0, "bfloat16"),  # the serving dtype
    ],
)
def test_flash_attention_masks_match_jax(hq, hkv, sq, skv, window, cap, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _both(_uniform(rng, (2, hq, sq, D), 8.0 if cap else 1.0), dtype)
    jk, tk = _both(_uniform(rng, (2, hkv, skv, D)), dtype)
    jv, tv = _both(_uniform(rng, (2, hkv, skv, D)), dtype)
    kw = dict(causal=True, sliding_window=window, logit_softcap=cap, save_residuals=True)
    j_out, j_lse = jax_flash_attention(jq, jk, jv, **kw)
    t_out, t_lse = flash_attention(tq, tk, tv, **kw)
    assert t_out.dtype == tq.dtype and t_lse.shape == tuple(j_lse.shape)
    assert _diff(t_out, j_out) <= TOL[dtype]
    assert _diff(t_lse, j_lse) <= FP32_TOL * 10  # base-2 LSE of magnitude ~log2(Skv)
    want = reference_attention(tq.float(), tk.float(), tv.float(), causal=True, sliding_window=window, logit_softcap=cap)
    assert _diff(t_out.float(), want.numpy()) <= (FP32_TOL if dtype == "float32" else 0.1)


def test_band_case_matches_jax():
    """window == block_kv == block_q (256, sub-blocks of 128) takes the JAX
    package's band kernel (_band_kernel, K2), as its
    tests/test_window_softcap.py::test_window_band_fast_path_matches_oracle
    does; the port computes the same function (its K2 is the windowed body
    for windows up to its 64-row kv tile: the window-64 case above).
    Self-attention over 3 blocks."""
    rng = np.random.default_rng(1)
    jq, tq = _both(_uniform(rng, (1, 2, 768, D)))
    jk, tk = _both(_uniform(rng, (1, 2, 768, D)))
    jv, tv = _both(_uniform(rng, (1, 2, 768, D)))
    bs = BlockSizes(256, 256, 1, 128)
    j_out, j_lse = jax_flash_attention(jq, jk, jv, causal=True, sliding_window=256, block_sizes=bs, save_residuals=True)
    t_out, t_lse = flash_attention(tq, tk, tv, causal=True, sliding_window=256, save_residuals=True)
    assert _diff(t_out, j_out) <= FP32_TOL and _diff(t_lse, j_lse) <= FP32_TOL * 10
    assert 256 > BAND_MAX_WINDOW  # on the card this window runs K1


def test_reference_masks_match_jax():
    rng = np.random.default_rng(2)
    jq, tq = _both(_uniform(rng, (2, 4, 48, D), 8.0))
    jk, tk = _both(_uniform(rng, (2, 2, 80, D)))
    jv, tv = _both(_uniform(rng, (2, 2, 80, D)))
    for window, cap in ((20, None), (None, 3.0), (33, 3.0)):
        want = jax_reference_attention(jq, jk, jv, causal=True, sliding_window=window, logit_softcap=cap)
        got = reference_attention(tq, tk, tv, causal=True, sliding_window=window, logit_softcap=cap)
        assert _diff(got, want) <= FP32_TOL
        out, lse = reference_attention_with_lse(tq, tk, tv, causal=True, sliding_window=window, logit_softcap=cap)
        assert _diff(out, want) <= FP32_TOL and bool(torch.isfinite(lse).all())


def test_masks_under_grad_raise():
    """Under grad a window or a softcap runs the port's autograd Function
    and gives the masked oracle's gradient, not the unmasked one."""
    q, k, v = (torch.rand(1, 2, 16, D) - 0.5 for _ in range(3))
    q.requires_grad_()
    for kw in ({"sliding_window": 4}, {"logit_softcap": 0.3}):
        out = flash_attention(q, k, v, causal=True, **kw)
        assert out.grad_fn is not None
        (got,) = torch.autograd.grad(out.sum(), q)
        (want,) = torch.autograd.grad(reference_attention(q, k, v, causal=True, **kw).sum(), q)
        (unmasked,) = torch.autograd.grad(reference_attention(q, k, v, causal=True).sum(), q)
        assert float((got - want).abs().max()) <= FP32_TOL < float((got - unmasked).abs().max())
        with torch.no_grad():
            assert flash_attention(q, k, v, causal=True, **kw).grad_fn is None
    assert flash_attention(q, k, v, causal=True).grad_fn is not None


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"sliding_window": 8}, "requires causal"),
        ({"causal": True, "sliding_window": 0}, "must be >= 1"),
        ({"logit_softcap": 0.0}, "logit_softcap must be > 0"),
    ],
)
def test_flash_attention_mask_validation(kw, match):
    x = torch.zeros((1, 2, 8, D))
    with pytest.raises(ValueError, match=match):
        flash_attention(x, x, x, **kw)


# ---------------------------------------------------------------- decode_attention


def _ring(rows_full: np.ndarray, lengths, buf: int, sinks: int = 0) -> np.ndarray:
    """Pack each sequence's dense rows [B, H, P, D] into a ring of ``buf``
    rows as the rolling cache stores them: position p at p % buf, or with
    sinks p below them and sinks_pad + (p - sinks) % (buf - sinks_pad)
    above; only the positions the ring still holds."""
    spad = -(-sinks // 128) * 128 if sinks else 0
    mod = buf - spad
    out = np.zeros(rows_full.shape[:2] + (buf, rows_full.shape[3]), np.float32)
    for b, length in enumerate(lengths):
        for p in range(length):
            if sinks and p < sinks:
                out[b, :, p] = rows_full[b, :, p]
            elif p >= length - mod:
                out[b, :, spad + (p - sinks) % mod if sinks else p % buf] = rows_full[b, :, p]
    return out


LAYOUTS = {  # name: (rows, window, sinks, softcap, ring)
    "dense window": (512, 200, 0, None, False),
    "ring": (384, 256, 0, 5.0, True),
    "ring with sinks": (128 + 256, 192, 4, None, True),
}


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_masks_match_jax(layout, kv_quant):
    """Sequence 3 has length 0: output 0 and LSE -inf in the port. Over a
    ring with sinks the JAX kernel gives NaN and +inf there (its sink mask
    admits no column, yet its live-block bound counts the sink rows), so
    that row is held to the contract alone (ROADMAP.md queue 4)."""
    rows, window, sinks, cap, ring = LAYOUTS[layout]
    rng = np.random.default_rng(3)
    lengths = [1000, 300, 90, 0] if ring else [512, 300, 70, 0]
    full = [rng.uniform(-1, 1, (4, 2, 1000, D)).astype(np.float32) for _ in range(2)]
    k, v = (_ring(x, lengths, rows, sinks) if ring else x[:, :, :rows] for x in full)
    q = _uniform(rng, (4, 4, D), 8.0 if cap else 1.0)
    if kv_quant == "none":
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    else:
        payload = jquant.payload_dtype(kv_quant), tquant.payload_dtype(kv_quant)
        jk, jv = (jquant.quantize_values(jnp.asarray(x), payload[0]) for x in (k, v))
        tk, tv = (tquant.quantize_values(torch.from_numpy(x), payload[1]) for x in (k, v))
    kw = dict(sliding_window=window, logit_softcap=cap, ring_buffer=ring, attention_sinks=sinks)
    j_lengths = jnp.asarray(lengths, jnp.int32)
    j_out, j_lse = jdecode.decode_attention(jnp.asarray(q), jk, jv, j_lengths, save_residuals=True, **kw)
    t_out, t_lse = tdecode.decode_attention(torch.from_numpy(q), tk, tv, torch.tensor(lengths, dtype=torch.int32),
                                            save_residuals=True, **kw)
    assert _diff(t_out[:3], j_out[:3]) <= FP32_TOL and _diff(t_lse[:3], j_lse[:3]) <= FP32_TOL
    assert bool((t_out[3] == 0).all()) and bool(torch.isneginf(t_lse[3]).all())
    if not sinks:
        assert _diff(t_out[3:], j_out[3:]) == 0.0 and _diff(t_lse[3:], j_lse[3:]) == 0.0


def test_ring_decode_equals_dense_window():
    """A ring holding the window gives the dense window's output (JAX's
    tests/test_rolling.py::test_ring_decode_kernel_matches_dense)."""
    rng = np.random.default_rng(4)
    lengths = [1000, 300, 100]
    k, v = (rng.uniform(-0.5, 0.5, (3, 2, 1024, D)).astype(np.float32) for _ in range(2))
    q = torch.from_numpy(_uniform(rng, (3, 8, D)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = tdecode.decode_attention(q, torch.from_numpy(k), torch.from_numpy(v), lens, sliding_window=256)
    got = tdecode.decode_attention(q, *(torch.from_numpy(_ring(x, lengths, 384)) for x in (k, v)), lens,
                                   sliding_window=256, ring_buffer=True)
    torch.testing.assert_close(got, want, rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"ring_buffer": True}, "requires sliding_window"),
        ({"ring_buffer": True, "sliding_window": 512}, "hold the whole window"),
        ({"attention_sinks": 4, "sliding_window": 8}, "requires ring_buffer"),
        ({"ring_buffer": True, "sliding_window": 200, "attention_sinks": 4}, "hold the whole window"),
        ({"sliding_window": 0}, "must be >= 1"),
    ],
)
def test_decode_mask_validation_matches_jax(kw, match):
    q, cache = torch.zeros((1, 2, D)), torch.zeros((1, 1, 256, D))
    lengths = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tdecode.decode_attention(q, cache, cache, lengths, **kw)
    with pytest.raises(ValueError, match=match):
        jdecode.decode_attention(jnp.zeros((1, 2, D)), jnp.zeros((1, 1, 256, D)), jnp.zeros((1, 1, 256, D)),
                                 jnp.ones((1,), jnp.int32), **kw)


# ---------------------------------------------------------------- paged


def _paged_ring(seed, *, sinks: bool, lengths, n_ring=4, pages_per_slot=8, kv_quant="none"):
    """A JAX PagedKVCache over the paged ring (each slot owns n_ring pages,
    one more pinned as logical page 0 with sinks; logical pages map onto
    them modulo their count, shuffled over the pool), and the port's copy.
    Rolled-out logical pages alias live ones."""
    rng = np.random.default_rng(seed)
    slots = len(lengths)
    owned = n_ring + int(sinks)
    num_pages = 1 + slots * owned
    perm = rng.permutation(np.arange(1, num_pages)).reshape(slots, owned)
    table = np.zeros((slots, pages_per_slot), np.int32)
    for b in range(slots):
        if sinks:
            table[b] = [perm[b, 0]] + [perm[b, 1 + (lp - 1) % n_ring] for lp in range(1, pages_per_slot)]
        else:
            table[b] = [perm[b, lp % n_ring] for lp in range(pages_per_slot)]
    k, v = (rng.uniform(-1, 1, (num_pages, 2, PAGE, D)).astype(np.float32) for _ in range(2))
    if kv_quant == "none":
        j = jpaged.PagedKVCache(*(jnp.asarray(x) for x in (k, v, table, np.asarray(lengths, np.int32))))
    else:
        payload = jquant.payload_dtype(kv_quant)
        kq, vq = (jquant.quantize_values(jnp.asarray(x), payload) for x in (k, v))
        scales = [jnp.swapaxes(x.scales, 2, 3) for x in (kq, vq)]  # the JAX pages' [P, H, 1, page]
        j = jpaged.PagedKVCache(kq.values, vq.values, jnp.asarray(table), jnp.asarray(lengths, jnp.int32), *scales)
    return j, kv_cache_from_jax(j, device="cpu")


@pytest.mark.parametrize(
    "window,sinks,cap,kv_quant",
    [(200, False, None, "none"), (200, True, None, "none"), (150, True, 5.0, "int8"), (1, True, None, "none")],
)
def test_paged_decode_masks_match_jax(window, sinks, cap, kv_quant):
    lengths = [1000, 640, 300, 1, 0]
    jc, tc = _paged_ring(5, sinks=sinks, lengths=lengths, kv_quant=kv_quant)
    rng = np.random.default_rng(6)
    q = _uniform(rng, (len(lengths), 4, D), 8.0 if cap else 1.0)
    kw = dict(sliding_window=window, logit_softcap=cap, attention_sinks=3 if sinks else 0)
    j_out, j_lse = jpaged.paged_decode_attention(jnp.asarray(q), jc, save_residuals=True, **kw)
    t_out, t_lse = tpaged.paged_decode_attention(torch.from_numpy(q), tc, save_residuals=True, **kw)
    assert _diff(t_out, j_out) <= FP32_TOL and _diff(t_lse, j_lse) <= FP32_TOL


@pytest.mark.parametrize("window,sinks,cap", [(200, False, None), (200, True, 5.0), (64, True, None)])
def test_paged_prefill_masks_match_jax(window, sinks, cap):
    """A 128-row chunk ending at logical row 896 of a slot whose ring holds
    4 (+1 pinned) of its 8 logical pages: the pages below the band alias
    the chunk's own."""
    jc, tc = _paged_ring(7, sinks=sinks, lengths=[896, 0])
    q = _uniform(np.random.default_rng(8), (1, 4, PAGE, D), 8.0 if cap else 1.0)
    kw = dict(sliding_window=window, logit_softcap=cap, attention_sinks=3 if sinks else 0)
    want = jpaged.paged_prefill_attention(jnp.asarray(q), jc, 0, 896, chunk_len=PAGE, **kw)
    got = tpaged.paged_prefill_attention(torch.from_numpy(q), tc, 0, 896, chunk_len=PAGE, **kw)
    assert _diff(got, want) <= FP32_TOL


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"attention_sinks": 4}, "requires sliding_window"),
        ({"attention_sinks": PAGE, "sliding_window": 64}, "pinned first page"),
        ({"sliding_window": 0}, "must be >= 1"),
        ({"logit_softcap": -1.0}, "logit_softcap must be > 0"),
    ],
)
def test_paged_mask_validation(kw, match):
    _, tc = _paged_ring(9, sinks=True, lengths=[10])
    with pytest.raises(ValueError, match=match):
        tpaged.paged_decode_attention(torch.zeros((1, 4, D)), tc, **kw)
    with pytest.raises(ValueError, match=match):
        tpaged.paged_prefill_attention(torch.zeros((1, 4, PAGE, D)), tc, 0, PAGE, chunk_len=PAGE, **kw)
