"""The port's ``utils/profiling.py`` and ``ModelConfig.tiny`` against the
JAX package's.

On the CPU: ``trace`` writes a Chrome trace file at each host level;
``profile_op`` follows JAX's protocol (call counts), gives a positive wall
time, and its keys are JAX's on the same function, less ``cost_analysis``;
the reading of a card's trace (``device_ops``, ``device_busy_share``) is
held on synthetic device records; ``ModelConfig.tiny`` equals JAX's with
and without overrides. (``calibrate_overhead_s`` raises without a card with
the other timers, ``tests/test_torch_benchmarking.py``.)
"""

from __future__ import annotations

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.utils import profiling as jax_profiling
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.utils import profiling


@pytest.mark.parametrize("level", [1, 2, 3])
def test_trace_writes_a_chrome_trace(tmp_path, level):
    x = torch.ones(8, 8)
    with profiling.trace(str(tmp_path / "t"), host_tracer_level=level) as prof:
        torch.mm(x, x)
    (path,) = (tmp_path / "t").iterdir()
    assert path.name.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.name == "aten::mm" for e in prof.events())
    shapes = [e.input_shapes for e in prof.events() if e.name == "aten::mm"]
    assert shapes == ([[[8, 8], [8, 8]]] if level == 3 else [[]])


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with profiling.trace(str(tmp_path)):
            raise KeyError("x")
    assert len(list(tmp_path.iterdir())) == 1


def test_trace_level_zero_needs_a_card(tmp_path):
    with pytest.raises(ValueError, match="no CUDA card"):
        with profiling.trace(str(tmp_path), host_tracer_level=0):
            pass


@pytest.mark.parametrize("log_dir", [False, True])
def test_profile_op_keys_are_jaxs_less_cost_analysis(tmp_path, log_dir):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    kw = {"log_dir": str(tmp_path)} if log_dir else {}
    theirs = jax_profiling.profile_op(jax.jit(lambda a: a @ a + 1.0), jnp.asarray(x), warmup=1, iters=2, **kw)
    ours = profiling.profile_op(lambda a: a @ a + 1.0, torch.from_numpy(x), warmup=1, iters=2, **kw)
    assert set(ours) == set(theirs) - {"cost_analysis"}
    assert set(ours["memory_analysis"]) == set(theirs["memory_analysis"])
    assert ours["wall_s_per_call"] > 0
    assert ours["trace_dir"] == theirs["trace_dir"] == kw.get("log_dir")
    assert ours["memory_analysis"] == {"argument_bytes": 256, "output_bytes": 256, "temp_bytes": None,
                                       "peak_bytes": None}
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir()) == log_dir


def test_profile_op_protocol_and_distinct_storages():
    calls = []
    x = torch.zeros(4, 16)

    def fn(a, tree):
        calls.append(1)
        return a[:2], a  # a view and its base: one storage

    out = profiling.profile_op(fn, x, {"a": x, "b": [x[1:], torch.zeros(3)]}, warmup=2, iters=5)
    assert len(calls) == 7
    assert out["memory_analysis"]["argument_bytes"] == 4 * 64 + 12
    assert out["memory_analysis"]["output_bytes"] == 4 * 64


def _event(name, start, end, device=torch.autograd.DeviceType.CUDA, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_device_reading_unions_overlaps_and_sorts_by_time():
    """Two streams overlap (a copy beside a kernel): their union, not their
    sum, is the busy time; host records and user annotations are not device
    operations."""
    events = [
        _event("gemm", 0.0, 40.0), _event("gemm", 100.0, 140.0),
        _event("nccl", 30.0, 60.0),  # overlaps the first gemm by 10 us
        _event("k6", 150.0, 160.0), _event("k6", 155.0, 158.0),
        _event("aten::mm", 0.0, 200.0, device=torch.autograd.DeviceType.CPU),
        _event("window", 0.0, 200.0, annotation=True),
    ]
    got = profiling._device_reading(events, iters=2, wall_s=100e-6)
    assert [op["name"] for op in got["device_ops"]] == ["gemm", "nccl", "k6"]
    assert got["device_ops"][0] == {"name": "gemm", "count": 1.0, "device_s_per_call": pytest.approx(40e-6)}
    assert got["device_ops"][2]["count"] == 1.0
    assert got["device_busy_share"] == pytest.approx((60.0 + 40.0 + 10.0) / 200.0)


def test_device_reading_raises_without_device_records():
    with pytest.raises(RuntimeError, match="no device record"):
        profiling._device_reading([_event("aten::mm", 0.0, 1.0, device=torch.autograd.DeviceType.CPU)], 1, 1.0)


@pytest.mark.parametrize("overrides", [{}, {"num_layers": 3, "dtype": "float32", "sliding_window": 8}])
def test_tiny_config_equals_jaxs(overrides):
    ours, theirs = tt.ModelConfig.tiny(**overrides), jt.ModelConfig.tiny(**overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.num_layers == overrides.get("num_layers", 2) and ours.model_dim == 256
