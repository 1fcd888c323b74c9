"""Parity of the PyTorch port's ops with the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernel in interpret mode on the CPU, as the JAX package's own
tests run it) and through the port's counterpart (its plain PyTorch version,
which is what the port runs for CPU tensors). The CUDA kernels themselves are
checked on the card by chip_smoke.py.

Tolerances:
  * fp32: 1e-4 — the same math, summed in another order;
  * bf16: 1.5e-2 — the JAX kernel rounds P to bf16 before P·V while the
    port keeps P in fp32; both are far under the 0.1 bar against the oracle.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import common as jax_common
from flash_attention_tpu.ops.decode import decode_attention as jax_decode_attention
from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu.ops.reference import (
    reference_attention as jax_reference_attention,
    reference_attention_with_lse as jax_reference_attention_with_lse,
)
from flash_attention_tpu_torch.ops import common
from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse
from flash_attention_tpu_torch.utils.testing import REFERENCE_TOLERANCE, assert_close, make_qkv

FP32_TOL = 1e-4
BF16_TOL = 1.5e-2
TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}


def _uniform(rng, shape):
    return rng.uniform(-0.5, 0.5, shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same fp32 numbers as a JAX and a torch array of ``dtype``."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_diff(got, want) -> float:
    got, want = _np(got), _np(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), "non-finite entries differ"
    assert np.array_equal(got[~fin], want[~fin]), "non-finite entries differ"
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


@pytest.mark.parametrize(
    "hq,hkv,sq,skv,d,causal,dtype",
    [
        (4, 4, 128, 128, 32, True, "float32"),  # MHA, causal
        (4, 4, 128, 128, 32, False, "float32"),  # MHA, non-causal
        (4, 2, 64, 192, 32, True, "float32"),  # GQA, Sq < Skv end-aligned
        (4, 2, 64, 192, 128, False, "float32"),  # GQA, non-causal, d=128
        (4, 1, 100, 130, 32, True, "float32"),  # MQA, ragged lengths
        (4, 2, 64, 192, 128, True, "bfloat16"),  # the serving dtype
        (2, 1, 256, 256, 128, True, "bfloat16"),  # one-shot prefill shape
    ],
)
def test_flash_attention_matches_jax(hq, hkv, sq, skv, d, causal, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _both(_uniform(rng, (2, hq, sq, d)), dtype)
    jk, tk = _both(_uniform(rng, (2, hkv, skv, d)), dtype)
    jv, tv = _both(_uniform(rng, (2, hkv, skv, d)), dtype)
    j_out, j_lse = jax_flash_attention(jq, jk, jv, causal=causal, save_residuals=True)
    t_out, t_lse = flash_attention(tq, tk, tv, causal=causal, save_residuals=True)
    assert t_out.shape == tuple(j_out.shape) and t_out.dtype == tq.dtype
    assert t_lse.shape == tuple(j_lse.shape) and t_lse.dtype == torch.float32
    assert _max_diff(t_out, j_out) <= TOL[dtype]
    assert _max_diff(t_lse, j_lse) <= FP32_TOL * 10  # base-2 LSE of magnitude ~log2(Skv)
    # And the port's own oracle agrees within the reference bar.
    assert_close(t_out, reference_attention(tq, tk, tv, causal=causal))


def test_sm_scale_matches_jax():
    rng = np.random.default_rng(4)
    jq, tq = _both(_uniform(rng, (1, 4, 32, 64)), "float32")
    jk, tk = _both(_uniform(rng, (1, 2, 48, 64)), "float32")
    want = jax_flash_attention(jq, jk, jk, causal=True, sm_scale=0.3)
    assert _max_diff(flash_attention(tq, tk, tk, causal=True, sm_scale=0.3), want) <= FP32_TOL
    lengths = np.array([40], np.int32)
    want = jax_decode_attention(jq[:, :, 0], jk, jk, jnp.asarray(lengths), sm_scale=0.3)
    got = decode_attention(tq[:, :, 0], tk, tk, torch.from_numpy(lengths), sm_scale=0.3)
    assert _max_diff(got, want) <= FP32_TOL


def test_flash_attention_cache_view_matches_copy():
    """A strided slice of a cache (the chunked-prefill operand) gives the
    same result as its contiguous copy."""
    q, k, v = make_qkv(1, 1, 4, 32, 32, num_kv_heads=2, kv_seq=96, dtype=torch.float32, device="cpu")
    cache = torch.zeros((3, 2, 128, 32))
    cache[1, :, :96] = k[0]
    view = cache[1:2, :, :96]
    assert not view.is_contiguous()
    torch.testing.assert_close(
        flash_attention(q, view, v, causal=True), flash_attention(q, view.contiguous(), v, causal=True),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 128])
def test_decode_attention_matches_jax(dtype, d):
    rng = np.random.default_rng(1)
    jq, tq = _both(_uniform(rng, (4, 8, d)), dtype)
    jk, tk = _both(_uniform(rng, (4, 2, 256, d)), dtype)
    jv, tv = _both(_uniform(rng, (4, 2, 256, d)), dtype)
    lengths = np.array([0, 1, 100, 256], np.int32)  # empty slot and full cache
    j_out = jax_decode_attention(jq, jk, jv, jnp.asarray(lengths))
    t_out = decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert t_out.shape == tuple(j_out.shape) and t_out.dtype == tq.dtype
    assert _max_diff(t_out, j_out) <= TOL[dtype]
    assert bool((t_out[0] == 0).all())  # length 0 -> output 0


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    rng = np.random.default_rng(2)
    jq, tq = _both(_uniform(rng, (3, 4, 48, 32)), "float32")
    jk, tk = _both(_uniform(rng, (3, 2, 80, 32)), "float32")
    jv, tv = _both(_uniform(rng, (3, 2, 80, 32)), "float32")
    lengths = np.array([0, 40, 80], np.int32)
    j_out = jax_reference_attention(jq, jk, jv, causal=causal, kv_length=jnp.asarray(lengths))
    t_out = reference_attention(tq, tk, tv, causal=causal, kv_length=torch.from_numpy(lengths))
    assert _max_diff(t_out, j_out) <= FP32_TOL
    j_out, j_lse = jax_reference_attention_with_lse(jq, jk, jv, causal=causal, kv_length=jnp.asarray(lengths))
    t_out, t_lse = reference_attention_with_lse(tq, tk, tv, causal=causal, kv_length=torch.from_numpy(lengths))
    assert _max_diff(t_out, j_out) <= FP32_TOL
    assert _max_diff(t_lse, j_lse) <= FP32_TOL * 10


def test_plain_versions_match_oracle():
    q, k, v = make_qkv(3, 2, 8, 64, 64, num_kv_heads=2, kv_seq=160, dtype=torch.float32, device="cpu")
    out, lse = flash_attention_plain(q, k, v, causal=True, sm_scale=0.125, save_residuals=True)
    want, want_lse = reference_attention_with_lse(q, k, v, causal=True, sm_scale=0.125)
    assert _max_diff(out, want) <= FP32_TOL and _max_diff(lse, want_lse) <= FP32_TOL * 10
    lengths = torch.tensor([0, 97])
    dec = decode_attention_plain(q[:, :, 0], k, v, lengths, sm_scale=0.125)
    want = reference_attention(q[:, :, :1], k, v, kv_length=lengths, sm_scale=0.125)[:, :, 0]
    assert _max_diff(dec, want) <= FP32_TOL


@pytest.mark.parametrize(
    "q_shape,k_shape,v_shape,causal",
    [
        ((1, 3, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32), False),  # Hq % Hkv != 0
        ((1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 9, 32), False),  # k/v mismatch
        ((2, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32), False),  # batch mismatch
        ((1, 4, 8, 32), (1, 2, 4, 32), (1, 2, 4, 32), True),  # causal, Skv < Sq
    ],
)
def test_flash_attention_rejects_bad_inputs(q_shape, k_shape, v_shape, causal):
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(q_shape), torch.zeros(k_shape), torch.zeros(v_shape), causal=causal)


def test_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor on another device is neither computed plainly nor silently
    moved: the wrapper raises (on CUDA it launches the kernel)."""
    q = torch.zeros((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_attention(q[:, :, 0], q, q, torch.zeros((1,), dtype=torch.int32, device="meta"))
    assert flash_attention.launches == 0 and decode_attention.launches == 0


def test_constants_match_jax():
    assert common.LOG2E == jax_common.LOG2E
    assert common.MASK_VALUE == jax_common.MASK_VALUE
    assert common.M_FLOOR == jax_common.M_FLOOR
    assert [common.ceil_to(x, 128) for x in (1, 128, 129)] == [128, 128, 256]
    assert REFERENCE_TOLERANCE == 0.1


def test_make_qkv_is_seeded():
    a = make_qkv(7, 1, 4, 16, 32, num_kv_heads=2, device="cpu")
    b = make_qkv(7, 1, 4, 16, 32, num_kv_heads=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == torch.bfloat16 and a[1].shape == (1, 2, 16, 32)
    assert float(a[0].float().abs().max()) <= 0.5


def test_import_leaves_jax_out_and_builds_nothing():
    code = (
        "import sys\n"
        "import flash_attention_tpu_torch, flash_attention_tpu_torch.serving.engine\n"
        "import flash_attention_tpu_torch.ops.quant, flash_attention_tpu_torch.models.convert\n"
        "from flash_attention_tpu_torch.ops import _build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert _build._KERNELS is None\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
