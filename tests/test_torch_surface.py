"""The port's public surface against the JAX package's.

Module by module: every public top-level function and class of each module
of the JAX package, and every public method of its public classes (the
inherited ones included), exists under the same name in the port's module
at the same path, apart from the TPU mechanisms and renames named below
with their reasons. Both packages are read with ``ast``.

Every name of the JAX package's ``__all__`` that the port has ported imports
from the port's top level, is in its ``__all__``, and takes the JAX
package's keywords, apart from the TPU kernels' tiling and interpreter
switches; calls written with JAX's keywords give JAX's results. Quantized payloads and scales are compared bit
for bit, attention outputs within 1e-4 (fp32, summed in another order).
"""

import ast
import inspect
import pathlib

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


JAX_DIR = pathlib.Path(jax_pkg.__file__).parent
PORT_DIR = pathlib.Path(port.__file__).parent
JAX_MODULES = sorted(str(p.relative_to(JAX_DIR)) for p in JAX_DIR.rglob("*.py"))
_V5E = ("v5e dispatch tables; the port picks per shape in ops/flash_attention.fwd_q_tile and "
        "ops/decode.decode_kv_splits")
_WIDEN = "a TPU fp8 bit-widen trick; the port's kernels widen the payload exactly on load (ROADMAP.md rules)"
# Modules and names of the JAX package the port leaves behind, by module, with the reason.
NOT_PORTED_MODULES = {"ops/tuning.py": _V5E}
NOT_PORTED = {
    "__init__.py": {"BlockSizes": _V5E, "select_block_sizes": _V5E, "select_bwd_block_sizes": _V5E},
    "ops/common.py": {name: _WIDEN for name in ("packed_pos", "packed_split_order", "split_scales_lanes",
                                                "upcast_kv_payload", "upcast_kv_payload_expfold",
                                                "upcast_kv_payload_packed")},
}
# Names the port gives another name: the card is not an MXU, and a config's dtype is a torch dtype.
RENAMED = {
    "utils/benchmarking.py": {"detect_mxu_peak_tflops": "detect_peak_tflops"},
    "models/transformer.py": {"ModelConfig.jnp_dtype": "ModelConfig.torch_dtype"},
    "models/attention.py": {"AttentionConfig.jnp_dtype": "AttentionConfig.torch_dtype"},
}


def _classes(root: pathlib.Path) -> dict:
    """Every class of a package by name: (its base names, its own public methods)."""
    out = {}
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ClassDef):
                bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr", "") for b in node.bases]
                methods = {m.name for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and not m.name.startswith("_")}
                out[node.name] = (bases, methods)
    return out


def _methods(name: str, classes: dict) -> set:
    bases, own = classes.get(name, ((), set()))
    return set(own).union(*(_methods(b, classes) for b in bases if b in classes))


def _surface(path: pathlib.Path, classes: dict) -> set:
    """A module's public names: its functions and classes, ``Class.method``
    for each public method, and the names of its ``__all__``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m}" for m in _methods(node.name, classes)}
        elif isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            names |= set(ast.literal_eval(node.value))
    return names


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_surface_is_the_jax_packages(module):
    if module in NOT_PORTED_MODULES:
        assert not (PORT_DIR / module).exists(), module
        return
    theirs = _surface(JAX_DIR / module, _classes(JAX_DIR))
    ours = _surface(PORT_DIR / module, _classes(PORT_DIR))
    renamed = RENAMED.get(module, {})
    left_behind = set(NOT_PORTED.get(module, {}))
    assert sorted(theirs - ours - left_behind - set(renamed)) == []
    # Each exception is still one: the name is JAX's and absent from the port, and a rename's target exists.
    assert left_behind <= theirs - ours
    assert set(renamed) <= theirs - ours and set(renamed.values()) <= ours


def test_exceptions_name_jax_modules():
    assert set(NOT_PORTED_MODULES) | set(NOT_PORTED) | set(RENAMED) <= set(JAX_MODULES)


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
