"""The port's split-decode API against the JAX package's, on the CPU.

The JAX package's tests/test_decode.py:140-187 cases on the port:
``decode_attention_split`` at 2 and 4 splits and over an int8 / fp8 cache,
the ``should_split_decode`` gate, and ``decode_attention(auto_split=True)``
against the unsplit call; plus the port's own contract: the JAX error when
max_seq does not divide into the splits, the CPU's plain split path
(``decode_split_plain``, the kernel's cut merged by
``merge_partial_attention``) taken exactly when a split is asked for, and
no kernel launched by a CPU call.

Inputs are fp32 U(-0.5, 0.5) from a numpy seed, handed to both packages.
Tolerance 1e-5 (the repository's fp32 parity bar for decode,
tests/test_torch_decode_split.py): both sides compute fp32 means of values
in (-1, 1), in other orders, so they differ by a few units in the last
place, while a row walked twice or dropped moves the output by more than
1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import decode as jdecode
from flash_attention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from flash_attention_tpu_torch.ops import decode as tdecode
from flash_attention_tpu_torch.ops.quant import quantize_kv as port_quantize_kv

TOL = 1e-5


def _inputs(seed, batch, q_heads, kv_heads, kv_seq, head_dim=128):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (batch, q_heads, head_dim)).astype(np.float32)
    k, v = (rng.uniform(-0.5, 0.5, (batch, kv_heads, kv_seq, head_dim)).astype(np.float32) for _ in range(2))
    return q, k, v


def _both(q, k, v, lengths, mode=None):
    """(port args, JAX args): fp32 tensors / arrays, or each package's
    quantization of the same rows."""
    tq, tk, tv, tl = (torch.from_numpy(x) for x in (q, k, v, lengths))
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lengths))
    if mode is not None:
        tk, tv = port_quantize_kv(tk, tv, mode)
        jk, jv = jax_quantize_kv(jk, jv, mode)
    return (tq, tk, tv, tl), (jq, jk, jv, jl)


def _diff(got, want) -> float:
    return float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("num_splits", [2, 4])
def test_decode_split_merge_matches_jax(num_splits):
    q, k, v = _inputs(38, 2, 4, 4, 512)
    port, jax_args = _both(q, k, v, np.array([512, 200], np.int32))
    got = tdecode.decode_attention_split(*port, num_splits=num_splits)
    want = jdecode.decode_attention_split(*jax_args, num_splits=num_splits, block_kv=128)
    assert _diff(got, want) <= TOL
    assert _diff(got, jdecode.decode_attention(*jax_args, block_kv=128)) <= TOL


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_decode_split_merge_quantized_matches_jax(mode):
    q, k, v = _inputs(39, 1, 4, 4, 512)
    port, jax_args = _both(q, k, v, np.array([450], np.int32), mode)
    got = tdecode.decode_attention_split(*port, num_splits=4)
    want = jdecode.decode_attention_split(*jax_args, num_splits=4, block_kv=128)
    assert _diff(got, want) <= TOL


def test_should_split_decode_gate():
    # Fires: small batch x kv_heads, long context.
    assert tdecode.should_split_decode(1, 8, 16384, 4096) > 1
    assert tdecode.should_split_decode(2, 8, 16384, 4096) > 1
    # Silent: big batch or short context.
    assert tdecode.should_split_decode(32, 8, 8192, 4096) == 0
    assert tdecode.should_split_decode(1, 8, 4096, 4096) == 0
    assert tdecode.should_split_decode(4, 8, 8192, 4096) == 0  # b*kvh = 32 > 16
    for args in [(1, 8, 16384, 4096), (1, 2, 8192, 64), (1, 1, 8192 * 3, 64), (2, 8, 9000, 2048), (1, 4, 12288, 4096),
                 (16, 1, 8192, 128), (1, 16, 8200, 4096)]:
        assert tdecode.should_split_decode(*args) == jdecode.should_split_decode(*args), args


def test_decode_auto_split_matches_jax_and_the_unsplit_call(monkeypatch):
    """The gate fires at 1 x 2 kv heads x 8192 rows: the CPU takes the plain
    split path with the gate's count; auto_split=False, or a mask, keeps the
    unsplit plain version."""
    q, k, v = _inputs(21, 1, 8, 2, 8192)
    port, jax_args = _both(q, k, v, np.array([7000], np.int32))
    seen = []
    plain_split = tdecode.decode_split_plain
    monkeypatch.setattr(tdecode, "decode_split_plain", lambda *a, **kw: seen.append(a[4]) or plain_split(*a, **kw))
    auto = tdecode.decode_attention(*port, auto_split=True)
    assert seen == [tdecode.should_split_decode(1, 2, 8192, tdecode.DECODE_RUN)] == [4]
    plain = tdecode.decode_attention(*port, auto_split=False)
    tdecode.decode_attention(*port, auto_split=True, sliding_window=5000)
    assert len(seen) == 1
    assert float((auto - plain).abs().max()) <= TOL
    assert _diff(auto, jdecode.decode_attention(*jax_args, auto_split=True)) <= TOL


def test_decode_split_needs_splits_that_divide_max_seq():
    q, k, v = _inputs(40, 1, 4, 4, 512)
    port, _ = _both(q, k, v, np.array([300], np.int32))
    with pytest.raises(ValueError, match="max_seq=512 % num_splits=3"):
        tdecode.decode_attention_split(*port, num_splits=3)
    with pytest.raises(ValueError, match="num_splits must be >= 1"):
        tdecode.decode_attention_split(*port, num_splits=0)


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 300, 512])
def test_more_splits_than_runs_and_short_sequences(length):
    """Sixteen splits over a sequence of a few 64-row runs leave splits
    empty; the merge skips them (an empty sequence gives output 0)."""
    q, k, v = _inputs(41, 2, 4, 2, 512)
    port, jax_args = _both(q, k, v, np.array([length, 512], np.int32))
    got = tdecode.decode_attention_split(*port, num_splits=16)
    want = tdecode.decode_attention_plain(*port, sm_scale=128**-0.5)
    assert float((got - want).abs().max()) <= TOL
    assert _diff(got, jdecode.decode_attention(*jax_args, block_kv=128)) <= TOL
    if length == 0:
        assert bool((got[0] == 0).all())


def test_cpu_split_launches_nothing():
    q, k, v = _inputs(42, 1, 4, 4, 512)
    port, _ = _both(q, k, v, np.array([400], np.int32))
    before = (tdecode.decode_attention.launches, tdecode.decode_attention.quant_launches)
    tdecode.decode_attention_split(*port, num_splits=4)
    tdecode.decode_attention_split(port[0], *port_quantize_kv(port[1], port[2], "int8"), port[3], num_splits=2)
    assert (tdecode.decode_attention.launches, tdecode.decode_attention.quant_launches) == before
