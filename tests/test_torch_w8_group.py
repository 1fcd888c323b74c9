"""The grouped W8A16 product (``ops/quant.w8_matmul_group``: one W1 launch on the card) against the JAX package.

A group is the weights of a layer that read the same x: q / k / v and gate /
up. On the CPU ``w8_matmul_group`` runs the per-weight plain version, which
the CUDA group launch (csrc/w8.cu ``w8_gemv_group_kernel``) is held to on the
card by ``chip_smoke.py`` phase 26. Here, at small widths, on inputs made
from numpy seeds:

  * each product of a group equals JAX's ``w8_dequant`` + einsum (widened to
    x's dtype as the port's ``_weight`` does, summed in fp32, rounded to x's
    dtype) within 1e-5 of the largest |out| in fp32 and one ulp in bf16 /
    fp16, for every layer layout (wq / wk / wv [M, H, D] over M, gate / up
    [K, N], wo [H, D, M] over (H, D)) and a group that mixes them;
  * each equals the per-weight ``w8_matmul_plain`` bit for bit, column shards
    (strided views of a tensor-parallel rank) included;
  * one-hot rows of x return each widened weight's rows bit for bit;
  * the model's ``_qkv`` and ``swiglu`` take one group call each when every
    weight of the group is int8 and no gradient is needed, giving the bits
    of the single products, and none under autograd.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.ops import _build, quant

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# (name, the group's weight shapes, contract axes, x's last axis)
GROUPS = [
    ("q / k / v", [(64, 4, 32), (64, 2, 32), (64, 2, 32)], 0, 64),
    ("gate / up", [(64, 160), (64, 160)], 0, 64),
    ("wo pair", [(4, 32, 64), (4, 32, 64)], (0, 1), 128),
    ("mixed", [(64, 4, 32), (64, 160)], 0, 64),
]
IDS = [g[0] for g in GROUPS]
CFG = dict(vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=32, mlp_dim=256)


def _weights(seed: int, shapes, axes):
    """fp32 weights quantized by the JAX package: ([port QuantizedTensor], [JAX QuantizedTensor])."""
    rng = np.random.default_rng(seed)
    tqs, jqs = [], []
    for shape in shapes:
        jq = jquant.quantize_weight(jnp.asarray(rng.normal(0, 0.05, shape).astype(np.float32)), contract_axes=axes)
        tqs.append(quant.QuantizedTensor(torch.from_numpy(np.array(jq.values)), torch.from_numpy(np.array(jq.scales))))
        jqs.append(jq)
    return tqs, jqs


def _x(seed: int, shape, dtype: str):
    tdt, jdt = DTYPES[dtype]
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)).to(tdt)
    return x, jnp.asarray(x.float().numpy()).astype(jdt)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        u = t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
        return torch.where((u & 0x8000) != 0, -(u & 0x7FFF), u & 0x7FFF)

    return int((ordered(a) - ordered(b)).abs().max())


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8),
                                                                     b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group", GROUPS, ids=IDS)
def test_group_matches_jax(group, dtype):
    name, shapes, axes, k = group
    tqs, jqs = _weights(GROUPS.index(group), shapes, axes)
    x, jx = _x(9, (2, 3, k), dtype)
    got = quant.w8_matmul_group(x, tqs)
    assert isinstance(got, tuple) and len(got) == len(tqs)
    lead = len(axes) if isinstance(axes, tuple) else 1
    for out, shape, jq in zip(got, shapes, jqs):
        assert out.shape == (2, 3, *shape[lead:]) and out.dtype == x.dtype
        wide = jquant.w8_dequant(jq).astype(DTYPES[dtype][1]).reshape(k, -1)
        want = jnp.einsum("bk,kn->bn", jx.reshape(-1, k), wide, preferred_element_type=jnp.float32)
        want = torch.from_numpy(np.asarray(want.astype(DTYPES[dtype][1]).astype(jnp.float32))).to(x.dtype)
        flat = out.reshape(want.shape)
        if dtype == "float32":
            assert float((flat - want).abs().max()) <= 1e-5 * float(want.abs().max())
        else:
            assert _ulps(flat, want) <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group", GROUPS, ids=IDS)
def test_group_equals_single_products(group, dtype):
    """Each product of the group is the per-weight plain product's bits,
    with an fp32 output too (the row-parallel partial's)."""
    name, shapes, axes, k = group
    tqs, _ = _weights(40 + GROUPS.index(group), shapes, axes)
    x, _ = _x(10, (5, k), dtype)
    for out_dtype in (None, torch.float32):
        got = quant.w8_matmul_group(x, tqs, out_dtype=out_dtype)
        for out, w in zip(got, tqs):
            assert _bits(out, quant.w8_matmul_plain(x, w, out_dtype=out_dtype))


@pytest.mark.parametrize("group", GROUPS, ids=IDS)
def test_group_one_hot_rows(group):
    """x's rows e_k return row k of each widened weight bit for bit, as the
    group launch must on the card."""
    name, shapes, axes, k = group
    tqs, jqs = _weights(70 + GROUPS.index(group), shapes, axes)
    ks = [0, 1, k // 2, k - 1]
    x = torch.zeros((len(ks), k), dtype=torch.bfloat16)
    x[torch.arange(len(ks)), ks] = 1
    for out, jq in zip(quant.w8_matmul_group(x, tqs), jqs):
        wide = np.asarray(jquant.w8_dequant(jq).astype(jnp.float32)).reshape(k, -1)[ks]
        assert _bits(out.reshape(len(ks), -1), torch.from_numpy(wide).to(torch.bfloat16))


@pytest.mark.parametrize("ranks", [2, 4])
def test_group_of_column_shards(ranks):
    """A tensor-parallel rank's column shards of q / k / v (strided views,
    as ``shard_model_params`` leaves them) give the plain products of
    contiguous copies of the shards, bit for bit."""
    tqs, _ = _weights(90 + ranks, [(64, 8, 32), (64, 4, 32), (64, 4, 32)], 0)
    x, _ = _x(11, (3, 64), "bfloat16")
    for rank in range(ranks):
        shards = []
        for w in tqs:
            heads = w.values.shape[1] // ranks
            shards.append(quant.QuantizedTensor(w.values.narrow(1, rank * heads, heads),
                                                w.scales.narrow(1, rank * heads, heads)))
        assert not shards[0].values.is_contiguous()
        for out, w in zip(quant.w8_matmul_group(x, shards), shards):
            copy = quant.QuantizedTensor(w.values.contiguous(), w.scales.contiguous())
            assert _bits(out, quant.w8_matmul_plain(x, copy))


def test_group_cpu_call_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "kernels", refuse)
    tqs, _ = _weights(5, [(64, 32), (64, 48)], 0)
    before = (quant.w8_matmul.w1_launches, quant.w8_matmul.w2_launches)
    for m in (1, 8, 33, 300):
        quant.w8_matmul_group(torch.ones((m, 64), dtype=torch.bfloat16), tqs)
    assert (quant.w8_matmul.w1_launches, quant.w8_matmul.w2_launches) == before


def _int8_model(dtype: str):
    cfg = tt.ModelConfig(**CFG, dtype=dtype, weight_quant="int8")
    params = tt.quantize_model_weights(tt.init_model_params(torch.Generator().manual_seed(3),
                                                            tt.ModelConfig(**CFG, dtype=dtype)))
    return cfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_takes_one_group_call_a_projection(dtype, monkeypatch):
    """A decode step of an int8 model calls the group wrapper twice a layer
    (q / k / v, gate / up), and its logits are the bits of the same model
    with every product made alone (``w8_matmul`` a weight)."""
    cfg, params = _int8_model(dtype)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, CFG["vocab_size"], (2, 9)).astype(np.int32))
    with torch.no_grad():
        _, caches = tt.prefill(params, cfg, toks, tt.init_caches(cfg, 2, 32, device="cpu"))
    step = toks[:, -1:]
    calls = []
    real = quant.w8_matmul_group

    def spy(x, ws, **kw):
        calls.append(len(tuple(ws)))
        return real(x, ws, **kw)

    monkeypatch.setattr(tattn, "w8_matmul_group", spy)
    monkeypatch.setattr(tt, "w8_matmul_group", spy)
    with torch.no_grad():
        grouped, _ = tt.decode_step_logits(params, cfg, step, caches)
    assert sorted(calls) == [2] * CFG["num_layers"] + [3] * CFG["num_layers"]

    def alone(x, ws, out_dtype=None):
        return tuple(quant.w8_matmul(x, w, out_dtype=out_dtype) for w in ws)

    monkeypatch.setattr(tattn, "w8_matmul_group", alone)
    monkeypatch.setattr(tt, "w8_matmul_group", alone)
    with torch.no_grad():
        single, _ = tt.decode_step_logits(params, cfg, step, caches)
    assert _bits(grouped, single)


def test_model_under_autograd_takes_no_group(monkeypatch):
    """With a gradient to keep (an fp32 x that requires it) the projections
    widen the weight in memory: no group call."""
    cfg, params = _int8_model("float32")

    def refuse(*args, **kw):
        raise AssertionError("a group call under autograd")

    monkeypatch.setattr(tattn, "w8_matmul_group", refuse)
    monkeypatch.setattr(tt, "w8_matmul_group", refuse)
    x = torch.randn((1, 4, CFG["model_dim"]), requires_grad=True)
    acfg = tattn.AttentionConfig(model_dim=CFG["model_dim"], num_q_heads=4, num_kv_heads=2, head_dim=32,
                                 dtype="float32")
    q, k, v = tattn._qkv(params["layers"][0]["attn"], acfg, x)
    out = tt.swiglu(x, params["layers"][0]["mlp"])
    (q.sum() + k.sum() + v.sum() + out.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
