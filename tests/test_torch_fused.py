"""Parity of the decode step's glue (``ops/fused.py``: F1-F3) with the JAX package.

On the CPU each wrapper runs its plain version, which the CUDA kernel
(csrc/fused.cu) is held to on the card by ``chip_smoke.py`` phase 25. Here
the plain versions are held to the JAX functions they replace, on inputs
made from numpy seeds:

  * F1 ``add_rms_norm`` against JAX's ``x + delta`` then ``rms_norm``: x_new
    bit-equal; h within 1e-6 of the largest |h| in fp32 (the sum of squares
    and the rsqrt round in another order) and within 1 ulp in bf16;
  * F2 ``rope``'s rotation against JAX's ``apply_rope`` at positions 0, 1,
    8191 and 70000 and over a chunk: within 4e-6 of the largest |x| in fp32
    (torch's and XLA's cos / sin each round within an ulp or two at angles
    up to 70000 rad) and 1 ulp in bf16; its row write against JAX's
    ``write_cache`` at T == 1 given the same rotated rows: payload bits,
    scales and lengths equal;
  * F3 ``swiglu_act`` against JAX's ``silu(gate) * up``: within 1e-6 of the
    largest |out| in fp32 and 1 ulp in bf16 (the two exp implementations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import rope as jrope
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import rope as trope
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax
from flash_attention_tpu_torch.ops import counters, fused

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ROPE_POSITIONS = (0, 1, 8191, 70000)


def _pair(x: np.ndarray, name: str):
    """x (fp32 numpy) rounded to ``name``: the same values as a torch tensor and a JAX array."""
    tdt, jdt = DTYPES[name]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Most bf16 units in the last place two bf16-valued fp32 arrays differ by."""
    def ordered(x):
        bits = x.astype(np.float32).view(np.uint32).astype(np.int64) >> 16
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits & 0x7FFF)

    return int(np.abs(ordered(a) - ordered(b)).max())


def _close(got, want, name: str, rel: float) -> None:
    g, w = _np(got), _np(want)
    if name == "bfloat16":
        assert _ulps(g, w) <= 1
    else:
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("width", [4096, 256])
@pytest.mark.parametrize("with_delta", [True, False])
def test_add_rms_norm_matches_jax(name, width, with_delta):
    rng = np.random.default_rng(width + with_delta)
    x, tx_j = _pair(rng.normal(size=(4, 3, width)).astype(np.float32) * 2, name)
    d, d_j = _pair(rng.normal(size=(4, 3, width)).astype(np.float32) * 2, name)
    w, w_j = _pair((1 + rng.uniform(-0.5, 0.5, width)).astype(np.float32), name)
    x_new, h = fused.add_rms_norm(x, d if with_delta else None, w, 1e-5)
    want_x = tx_j + d_j if with_delta else tx_j
    assert np.array_equal(_np(x_new), _np(want_x))
    _close(h, jt.rms_norm(want_x, w_j, 1e-5), name, 1e-6)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("head_dim", [128, 32])
def test_rope_rotation_matches_jax(name, head_dim):
    rng = np.random.default_rng(head_dim)
    q, q_j = _pair(rng.normal(size=(4, 8, 1, head_dim)).astype(np.float32), name)
    k, k_j = _pair(rng.normal(size=(4, 2, 1, head_dim)).astype(np.float32), name)
    pos = np.asarray(ROPE_POSITIONS, np.int32)[:, None, None]
    got_q, got_k = fused.rope(q, k, torch.from_numpy(pos))
    _close(got_q, jrope.apply_rope(q_j, jnp.asarray(pos)), name, 4e-6)
    _close(got_k, jrope.apply_rope(k_j, jnp.asarray(pos)), name, 4e-6)
    # A chunk: 64 rows from position 70000, one position a row for every head.
    qc, qc_j = _pair(rng.normal(size=(1, 8, 64, head_dim)).astype(np.float32), name)
    kc, kc_j = _pair(rng.normal(size=(1, 2, 64, head_dim)).astype(np.float32), name)
    cpos = (70000 + np.arange(64, dtype=np.int32))[None, None, :]
    got_q, got_k = fused.rope(qc, kc, torch.from_numpy(cpos))
    _close(got_q, jrope.apply_rope(qc_j, jnp.asarray(cpos)), name, 4e-6)
    _close(got_k, jrope.apply_rope(kc_j, jnp.asarray(cpos)), name, 4e-6)


ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32)
# (AttentionConfig fields, rows a slot, lengths): a slot at capacity, a ring
# passed several times, the sinks' rows and the ring behind them.
WRITE_CASES = {
    "bfloat16": (dict(dtype="bfloat16"), 256, (5, 0, 256)),
    "float32": (dict(dtype="float32"), 256, (255, 7, 256)),
    "int8": (dict(dtype="bfloat16", kv_quant="int8"), 256, (5, 0, 256)),
    "fp8_e4m3": (dict(dtype="bfloat16", kv_quant="fp8_e4m3"), 256, (5, 255, 256)),
    "fp8_e5m2": (dict(dtype="float32", kv_quant="fp8_e5m2"), 256, (5, 0, 256)),
    "rolling": (dict(dtype="bfloat16", sliding_window=100, rolling=True), 1000, (5, 128, 1000)),
    "rolling + sinks": (dict(dtype="float32", sliding_window=100, rolling=True, attention_sinks=4), 1000,
                        (2, 4, 900)),
    "rolling int8": (dict(dtype="bfloat16", sliding_window=100, rolling=True, kv_quant="int8"), 1000,
                     (0, 129, 257)),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_rope_row_write_matches_jax_write_cache(case):
    fields, max_seq, lengths = WRITE_CASES[case]
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    name = "bfloat16" if fields["dtype"] == "bfloat16" else "float32"
    rng = np.random.default_rng(len(case))
    jc = jattn.init_kv_cache(jcfg, 3, max_seq)
    # Filled rows, so a write into the wrong row shows.
    fill = {f: jnp.asarray(rng.uniform(-1, 1, getattr(jc, f).shape), getattr(jc, f).dtype) for f in ("k", "v")}
    jc = jc._replace(**fill, lengths=jnp.asarray(lengths, jnp.int32))
    tc = kv_cache_from_jax(jc, device="cpu")
    q, _ = _pair(rng.normal(size=(3, 4, 1, 32)).astype(np.float32), name)
    k, _ = _pair(rng.normal(size=(3, 2, 1, 32)).astype(np.float32) * 3, name)
    v, v_j = _pair(rng.normal(size=(3, 2, 1, 32)).astype(np.float32) * 3, name)
    got_q, got_k, got = fused.rope(q, k, tc.lengths[:, None, None], cache=tc, v=v, ring=tcfg.rolling,
                                   sinks=tcfg.attention_sinks)
    assert got.lengths is not tc.lengths  # replaced, not mutated
    want = kv_cache_from_jax(jattn.write_cache(jcfg, jc, _pair(got_k.float().numpy(), name)[1], v_j, jc.lengths),
                             device="cpu")
    for a, b in zip(got, want):
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                                                      b.view(torch.uint8) if b.element_size() == 1 else b)
    assert got.lengths.tolist() == want.lengths.tolist()


@pytest.mark.parametrize("name", list(DTYPES))
def test_swiglu_act_matches_jax(name):
    rng = np.random.default_rng(3)
    g, g_j = _pair(rng.normal(size=(4, 1, 512)).astype(np.float32) * 3, name)
    u, u_j = _pair(rng.normal(size=(4, 1, 512)).astype(np.float32) * 3, name)
    want = (jax.nn.silu(g_j.astype(jnp.float32)) * u_j.astype(jnp.float32)).astype(DTYPES[name][1])
    _close(fused.swiglu_act(g, u), want, name, 1e-6)


def test_the_cpu_route_launches_nothing_and_reuses_the_frequency_table():
    counters.zero()
    x = torch.ones(2, 1, 8)
    fused.add_rms_norm(x, x, torch.ones(8), 1e-5)
    fused.swiglu_act(x, x)
    fused.rope(torch.ones(1, 2, 1, 8), torch.ones(1, 1, 1, 8), torch.zeros(1, 1, 1, dtype=torch.int32))
    assert {k: counters.read()[k] for k in ("F1", "F2", "F3")} == {"F1": 0, "F2": 0, "F3": 0}
    assert trope.rope_table(8, 10000.0, x.device) is trope.rope_table(8, 10000.0, x.device)
