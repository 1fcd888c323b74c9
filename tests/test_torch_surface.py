"""The port's public surface against the JAX package's.

Every name of the JAX package's ``__all__`` that the port has ported imports
from the port's top level, is in its ``__all__``, and takes the JAX
package's keywords, apart from the TPU kernels' tiling and interpreter
switches; calls written with JAX's keywords give JAX's results. Quantized payloads and scales are compared bit
for bit, attention outputs within 1e-4 (fp32, summed in another order).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_tpu as jax_pkg
import flash_attention_tpu_torch as port
from flash_attention_tpu.ops import quant as jax_quant
from flash_attention_tpu_torch.ops import quant as port_quant

FP32_TOL = 1e-4
PORTED = ("reference_attention", "flash_attention", "decode_attention", "quantize_weight",
          "merge_partial_attention", "merge_two", "QuantizedTensor", "quantize_kv", "decode_attention_split",
          "save_kv_cache", "load_kv_cache", "initialize_distributed", "fail_fast", "StepWatchdog")
# Keywords of the JAX functions that steer the Pallas kernels' tiling and
# the interpreter.
TPU_KNOBS = {"block_sizes", "bwd_block_sizes", "interpret", "block_kv", "d64_unpadded"}


# The port's own top-level names: tensor-parallel serving, which JAX gets from GSPMD behind ``shard_caches``.
PORT_ONLY = ("shard_model_params", "make_cache_sharding")


def test_ported_names_are_the_jax_packages():
    assert set(PORTED) <= set(jax_pkg.__all__)
    assert not set(PORT_ONLY) & set(jax_pkg.__all__)
    assert set(port.__all__) == set(PORTED) | set(PORT_ONLY)


@pytest.mark.parametrize("name", PORTED)
def test_ported_name_takes_jax_keywords(name):
    ours, theirs = getattr(port, name), getattr(jax_pkg, name)
    keywords = set(inspect.signature(theirs).parameters) - TPU_KNOBS
    assert keywords <= set(inspect.signature(ours).parameters), name


def _rng_array(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).uniform(-1.0, 1.0, shape) * scale).astype(np.float32)


def _same_quant(ours, theirs):
    """Payload and scales bit-equal (an fp8 payload compared as its bytes)."""
    fp8 = ours.values.dtype.is_floating_point
    values, want = ours.values, np.asarray(theirs.values)
    if fp8:
        values, want = values.view(torch.uint8), want.view(np.uint8)
    assert np.array_equal(values.numpy(), want)
    assert np.array_equal(ours.scales.numpy(), np.asarray(theirs.scales))


@pytest.mark.parametrize("axes", [0, (0, 1), -1])
def test_quantize_weight_contract_axes(axes):
    w = _rng_array(1, (16, 4, 24))
    _same_quant(port.quantize_weight(torch.from_numpy(w), contract_axes=axes),
                jax_pkg.quantize_weight(jnp.asarray(w), contract_axes=axes))


@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_int8_and_fp8_axis(axis):
    x = _rng_array(2, (6, 5, 32), 3.0)
    _same_quant(port_quant.quantize_int8(torch.from_numpy(x), axis=axis), jax_quant.quantize_int8(jnp.asarray(x), axis=axis))
    _same_quant(port_quant.quantize_fp8(torch.from_numpy(x), axis=axis, dtype=torch.float8_e4m3fn),
                jax_quant.quantize_fp8(jnp.asarray(x), axis=axis, dtype=jnp.float8_e4m3fn))


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quantize_kv(mode):
    k, v = _rng_array(3, (2, 2, 16, 32)), _rng_array(4, (2, 2, 16, 32))
    ours = port.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), mode)
    theirs = jax_pkg.quantize_kv(jnp.asarray(k), jnp.asarray(v), mode)
    for o, t in zip(ours, theirs):
        assert isinstance(o, port.QuantizedTensor)
        _same_quant(o, t)


def test_merge_with_jax_keywords():
    o = _rng_array(5, (2, 3, 4, 8, 16))  # [B, splits, H, q, d], split axis 1
    lse = _rng_array(6, (2, 3, 4, 8), 4.0)
    lse[0, 1] = -np.inf  # an empty part
    ours = port.merge_partial_attention(torch.from_numpy(o), torch.from_numpy(lse), axis=1)
    theirs = jax_pkg.merge_partial_attention(jnp.asarray(o), jnp.asarray(lse), axis=1)
    for a, b in zip(ours, theirs):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= FP32_TOL
    ours = port.merge_two(*(torch.from_numpy(x) for x in (o[:, 0], lse[:, 0], o[:, 2], lse[:, 2])))
    theirs = jax_pkg.merge_two(*(jnp.asarray(x) for x in (o[:, 0], lse[:, 0], o[:, 2], lse[:, 2])))
    for a, b in zip(ours, theirs):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= FP32_TOL


def test_attention_with_jax_keywords():
    q, k, v = _rng_array(7, (2, 4, 64, 32), 0.5), _rng_array(8, (2, 2, 64, 32), 0.5), _rng_array(9, (2, 2, 64, 32), 0.5)
    ids = np.repeat(np.array([[0] * 20 + [1] * 44]), 2, axis=0).astype(np.int32)
    kw = dict(causal=True, sm_scale=0.3, sliding_window=30, logit_softcap=5.0)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    j = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(jax_pkg.reference_attention(*j, out_dtype=jnp.float32, segment_ids=jnp.asarray(ids), **kw))
    got = port.reference_attention(*t, out_dtype=torch.float32, segment_ids=torch.from_numpy(ids), **kw)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL
    got = port.flash_attention(*t, segment_ids=torch.from_numpy(ids), save_residuals=False, **kw)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL
    lengths = np.array([5, 64], np.int32)
    dkw = dict(sm_scale=0.3, save_residuals=False, sliding_window=16, logit_softcap=5.0, ring_buffer=False,
               attention_sinks=0)
    want = np.asarray(jax_pkg.decode_attention(jnp.asarray(q[:, :, 0]), j[1], j[2], jnp.asarray(lengths), **dkw))
    got = port.decode_attention(torch.from_numpy(q[:, :, 0].copy()), t[1], t[2], torch.from_numpy(lengths), **dkw)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL


def test_split_decode_with_jax_keywords():
    q, k, v = _rng_array(10, (2, 4, 32), 0.5), _rng_array(11, (2, 2, 512, 32), 0.5), _rng_array(12, (2, 2, 512, 32), 0.5)
    lengths = np.array([7, 400], np.int32)
    kw = dict(num_splits=4, sm_scale=0.3)
    want = np.asarray(jax_pkg.decode_attention_split(*(jnp.asarray(x) for x in (q, k, v, lengths)), block_kv=128, **kw))
    got = port.decode_attention_split(*(torch.from_numpy(x) for x in (q, k, v, lengths)), **kw)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL
    want = np.asarray(jax_pkg.decode_attention(*(jnp.asarray(x) for x in (q, k, v, lengths)), auto_split=True, sm_scale=0.3))
    got = port.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, lengths)), auto_split=True, sm_scale=0.3)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL
