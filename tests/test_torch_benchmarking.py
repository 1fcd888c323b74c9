"""The port's utils/benchmarking.py against the JAX package's.

``attention_flops`` is the same formula (causal halving, the window band and
its ValueError) and must give the same numbers; the timers time CUDA cards
only, so on the CPU each of them raises.
"""

from __future__ import annotations

import pytest
import torch

from flash_attention_tpu.utils import benchmarking as jax_bench
from flash_attention_tpu_torch.utils import benchmarking


@pytest.mark.parametrize("shape", [(1, 32, 512, 128), (2, 8, 2048, 64), (4, 3, 1000, 32), (1, 32, 8192, 128)])
@pytest.mark.parametrize("kw", [
    dict(causal=False), dict(causal=True), dict(causal=False, kv_seq=4096), dict(causal=True, kv_seq=300),
    dict(causal=True, window=1), dict(causal=True, window=256), dict(causal=True, window=100_000),
])
def test_attention_flops_equals_jax(shape, kw):
    assert benchmarking.attention_flops(*shape, **kw) == jax_bench.attention_flops(*shape, **kw)


@pytest.mark.parametrize("kw", [dict(causal=False, window=64), dict(causal=True, kv_seq=512, window=64)])
def test_attention_flops_window_raises_as_jax(kw):
    for fn in (benchmarking.attention_flops, jax_bench.attention_flops):
        with pytest.raises(ValueError, match="causal self-attention"):
            fn(1, 4, 256, 64, **kw)


@pytest.mark.parametrize("call", [
    lambda: benchmarking.time_fn(lambda: None),
    lambda: benchmarking.scan_timer(lambda: None, ()),
    lambda: benchmarking.bench_attention(lambda: None, name="x", flops=1.0, peak_tflops=989.0),
    benchmarking.detect_peak_tflops,
    benchmarking.card_description,
    benchmarking.calibrate_overhead_s,
])
def test_timers_raise_without_a_card(call):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("timer", ["time_fn", "scan_timer"])
def test_timers_refuse_cpu_tensors(monkeypatch, timer):
    """Even where a card is present, a CPU operand is refused, never timed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="cpu"):
        if timer == "time_fn":
            benchmarking.time_fn(torch.neg, x)
        else:
            benchmarking.scan_timer(torch.neg, (x,))


def test_peak_table_and_result_row():
    assert benchmarking.TENSOR_PEAK_TFLOPS == {"H100": 989.0, "H200": 989.0}
    res = benchmarking.BenchResult(name="k1", avg_time_s=2e-3, run_times_s=[2e-3, 2e-3], tflops=494.5,
                                   roofline_frac=0.5)
    assert res.row().split() == ["k1", "2.000ms", "2.000ms", "avg", "2.000ms", "494.50", "TFLOPS", "(", "50.0%",
                                 "roofline)"]
