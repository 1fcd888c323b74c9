"""Parity of the W8A16 product (``ops/quant.w8_matmul``: kernels W1 / W2) with the JAX package.

On the CPU ``w8_matmul`` runs its plain version, which the CUDA kernels
(csrc/w8.cu) are held to on the card by ``chip_smoke.py`` phase 26. Here the
plain version is held to what the JAX package computes with the same int8
payload and scales (its ``quantize_weight``), on inputs made from numpy seeds:

  * scale on the weight (wq [M, H, D], wo [H, D, M] over (0, 1), w_gate /
    w_down [K, N]): JAX's ``w8_dequant`` (bf16), widened to x's dtype as the
    port's ``_weight`` does, in an fp32 ``einsum``, rounded to x's dtype:
    within 1e-5 of the largest |out| in fp32 and one ulp in bf16 / fp16 (the
    fp32 sums run in another order);
  * scale on the output (the tied unembed [V, K], the row's scale on the fp32
    sum): within 1e-5 of the largest |out|, whatever x's dtype;
  * one-hot rows of x return the widened weight's rows (or the code times
    the scale) bit for bit, the check ``chip_smoke.py`` repeats on the card.

And through the model: a tiny ``weight_quant="int8"`` model's prefill and
decode logits within LOGIT_TOL of JAX's in fp32 (BF16_LOGIT_REL of the
largest in bf16, whose MLP rounds apart from JAX's), and the unembed's
product kept in fp32 as JAX's ``preferred_element_type=float32`` keeps it: a
model of no layers (only the final norm and the unembed) within 1e-5 of
JAX's largest logit, bf16 and int8 weights alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.ops import _build, counters, quant

LOGIT_TOL = 1e-3  # tests/test_torch_models.py's
BF16_LOGIT_REL = 2e-2  # a bf16 model's logits against JAX's, of the largest (test_int8_model_matches_jax)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# (name, weight shape, contract axes, x's last axis): ModelConfig()'s layouts at a small width.
LAYOUTS = [
    ("wq", (64, 4, 32), 0, 64),
    ("wo", (4, 32, 64), (0, 1), 128),
    ("w_gate", (64, 160), 0, 64),
    ("w_down", (160, 64), 0, 160),
]
CFG = dict(vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=32, mlp_dim=256)


def _weight(seed: int, shape, contract_axes):
    """One fp32 weight quantized by the JAX package: (port QuantizedTensor, JAX QuantizedTensor)."""
    w = np.random.default_rng(seed).normal(0, 0.05, shape).astype(np.float32)
    jq = jquant.quantize_weight(jnp.asarray(w), contract_axes=contract_axes)
    tq = quant.QuantizedTensor(torch.from_numpy(np.asarray(jq.values)), torch.from_numpy(np.asarray(jq.scales)))
    return tq, jq


def _x(seed: int, shape, name: str):
    tdt, jdt = DTYPES[name]
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)).to(tdt)
    return x, jnp.asarray(x.float().numpy()).astype(jdt)


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Most units in the last place two tensors of one 16-bit dtype differ by."""
    def ordered(t):
        u = t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
        return torch.where((u & 0x8000) != 0, -(u & 0x7FFF), u & 0x7FFF)

    return int((ordered(a) - ordered(b)).abs().max())


def _jax_layer_product(x, jq, contract_axes, jdt):
    """JAX's product with the weight widened as the port widens it: w8_dequant
    (bf16), then x's dtype, summed in fp32, rounded to x's dtype."""
    axes = contract_axes if isinstance(contract_axes, tuple) else (contract_axes,)
    wide = jquant.w8_dequant(jq).astype(jdt)
    wide = wide.reshape(x.shape[-1], -1) if len(axes) > 1 else wide.reshape(wide.shape[0], -1)
    out = jnp.einsum("bk,kn->bn", x.reshape(-1, x.shape[-1]), wide, preferred_element_type=jnp.float32)
    return out.astype(jdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=[layout[0] for layout in LAYOUTS])
def test_layer_weight_matches_jax(layout, dtype):
    name, shape, axes, k = layout
    tq, jq = _weight(LAYOUTS.index(layout), shape, axes)
    x, jx = _x(7, (2, 3, k), dtype)
    got = quant.w8_matmul(x, tq)
    out_shape = shape[len(axes) if isinstance(axes, tuple) else 1:]
    assert got.shape == (2, 3, *out_shape) and got.dtype == x.dtype
    want = torch.from_numpy(_np(_jax_layer_product(jx, jq, axes, DTYPES[dtype][1]))).to(x.dtype)
    got = got.reshape(want.shape)
    if dtype == "float32":
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        assert _ulps(got, want) <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unembed_matches_jax(dtype):
    tq, jq = _weight(11, (96, 64), 1)
    x, jx = _x(12, (2, 5, 64), dtype)
    got = quant.w8_matmul(x, tq, out_dtype=torch.float32, scale_on_output=True)
    want = jnp.einsum("btm,vm->btv", jx, jq.values.astype(DTYPES[dtype][1]), preferred_element_type=jnp.float32)
    want = _np(want * jq.scales[:, 0].astype(jnp.float32)[None, None, :])
    assert got.shape == (2, 5, 96) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", LAYOUTS + [("unembed", (96, 64), 1, 64)],
                         ids=[layout[0] for layout in LAYOUTS] + ["unembed"])
def test_one_hot_rows_are_the_widened_weight(layout, dtype):
    """x's rows e_k return row k of the widened weight bit for bit (the
    unembed: code times scale in fp32), as the kernels must on the card."""
    name, shape, axes, k = layout
    tq, jq = _weight(3, shape, axes)
    tdt, jdt = DTYPES[dtype]
    ks = [0, 1, k // 2, k - 1]
    x = torch.zeros((len(ks), k), dtype=tdt)
    x[torch.arange(len(ks)), ks] = 1
    if name == "unembed":
        got = quant.w8_matmul(x, tq, out_dtype=torch.float32, scale_on_output=True)
        want = jq.values.astype(jnp.float32)[:, ks].T * jq.scales[:, 0][None, :]
        assert np.array_equal(got.numpy(), np.asarray(want))
        return
    got = quant.w8_matmul(x, tq).reshape(len(ks), -1)
    wide = np.asarray(jquant.w8_dequant(jq).astype(jnp.float32)).reshape(k, -1)[ks]
    want = torch.from_numpy(wide).to(torch.bfloat16).to(tdt)  # bf16 values, in x's dtype as _weight rounds them
    assert got.dtype == tdt and torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_cpu_call_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "kernels", refuse)
    tq, _ = _weight(5, (64, 32), 0)
    before = (quant.w8_matmul.w1_launches, quant.w8_matmul.w2_launches)
    for m in (1, 8, 33, 300):
        quant.w8_matmul(torch.ones((m, 64), dtype=torch.bfloat16), tq)
    assert (quant.w8_matmul.w1_launches, quant.w8_matmul.w2_launches) == before


def test_kernels_registered():
    assert counters.KERNELS["W1"] == (quant.w8_matmul, "w1_launches",
                                      ("w8_gemv_kernel", "w8_gemv_group_kernel", "w8_gemv_fma_kernel"))
    assert counters.KERNELS["W2"] == (quant.w8_matmul, "w2_launches", ("w8_gemm_kernel",))
    names = ["void (anonymous namespace)::w8_gemv_kernel<__nv_bfloat16, 1, true>(GemvParams)",
             "void (anonymous namespace)::w8_gemv_group_kernel<__half, 4, false>(GroupParams)",
             "(anonymous namespace)::w8_gemv_fma_kernel(GemvParams)",
             "void (anonymous namespace)::w8_gemm_kernel<__half, true, 128>(GemmParams)"]
    traced = counters.traced(names)
    assert traced[("W1",)] == 3 and traced[("W2",)] == 1


# (rows of x, each weight's N, K): ModelConfig()'s decode groups (q / k / v,
# gate / up) and single weights (wo, w_down, wk), 32 slots, a
# tensor-parallel shard, a short K, odd shapes, more rows than one group.
PLAN_CASES = [(8, (4096, 1024, 1024), 4096), (8, (11008, 11008), 4096), (8, (4096,), 4096), (8, (4096,), 11008),
              (32, (4096, 1024, 1024), 4096), (1, (2752, 2752), 4096), (37, (64,), 100), (8, (1024,), 4096),
              (8, (72, 100, 40), 16), (64, (11008,), 4096)]


@pytest.mark.parametrize("shape", PLAN_CASES, ids=[f"{m}x{'-'.join(map(str, ns))}x{k}" for m, ns, k in PLAN_CASES])
def test_w1_plan_covers_k(shape):
    """W1's work items (``w1_work``, the kernel's block order): every
    (weight, row group, 128-column strip, 16-row k-step) in exactly one
    item, none empty, a split of whole TMA boxes (except the last), at most
    W1_MAX_SPLITS blocks a cluster, and a split only where the strips alone
    leave the card short of W1_BLOCKS_PER_SM blocks a multiprocessor; at
    ModelConfig()'s shapes the measured best splits."""
    m, ns, k = shape
    xt, splits, steps = quant.w1_plan(m, ns, k)
    assert xt == (1 if m <= 8 else 2 if m <= 16 else 4)
    assert 1 <= splits <= quant.W1_MAX_SPLITS and steps % quant.W1_BOX_STEPS == 0
    ksteps, groups = -(-k // 16), -(-m // (8 * xt))
    work = quant.w1_work(m, ns, k)
    items = groups * sum(-(-n // quant.W1_COLS) for n in ns)
    assert len(work) == items * splits
    assert splits == 1 or items * splits <= quant.W1_BLOCKS_PER_SM * 132
    covered = set()
    for i, group, strip, first, end in work:
        assert first < end and end - first <= steps
        for step in range(first, end):
            assert (i, group, strip, step) not in covered
            covered.add((i, group, strip, step))
    assert covered == {(i, group, strip, step) for i, n in enumerate(ns) for group in range(groups)
                       for strip in range(-(-n // quant.W1_COLS)) for step in range(ksteps)}
    measured = {(8, (4096, 1024, 1024), 4096): 2, (8, (11008, 11008), 4096): 1, (8, (4096,), 4096): 3,
                (8, (4096,), 11008): 6}
    assert measured.get(shape, splits) == splits


@pytest.mark.parametrize("shape", [(256, 4096), (256, 1024), (256, 11008), (1024, 4096), (1024, 11008),
                                   (1024, 32000), (64, 4096), (40, 72)])
def test_w2_plan_fills_the_card(shape):
    """W2's tile height and grid: 64 or 128 x rows, one persistent block a
    multiprocessor at most and no more blocks than tiles; at 256 rows over
    wq's 4096 columns the 64-row tiles fill 128 multiprocessors."""
    m, n = shape
    bm, grid = quant.w2_plan(m, n)
    tiles = -(-m // bm) * -(-n // quant.W2_COLS)
    assert bm in quant.W2_ROWS and grid == min(132, tiles)
    if (m, n) == (256, 4096):
        assert (bm, grid) == (64, 128)


def _models(dtype: str, weight_quant: str, **over):
    cfg = dict(CFG, dtype=dtype, weight_quant=weight_quant, **over)
    jcfg, tcfg = jt.ModelConfig(**cfg), tt.ModelConfig(**cfg)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_model_matches_jax(dtype):
    """Prefill, then decode steps of a tiny int8-weight model on JAX's
    greedy tokens: fp32 logits within LOGIT_TOL and the same tokens; bf16
    logits within BF16_LOGIT_REL of the largest (the bf16 model without
    quantization is 8.2e-3 of it from JAX's on the parent tree and this
    one: the port rounds the MLP's gate and up to bf16 where JAX keeps them
    in fp32; with int8 weights 1.1e-2)."""
    jcfg, tcfg, jparams, tparams = _models(dtype, "int8")
    toks = np.random.default_rng(4).integers(0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    j_logits, j_caches = jt.prefill(jparams, jcfg, jnp.asarray(toks), jt.init_caches(jcfg, 2, 64))
    t_logits, t_caches = tt.prefill(tparams, tcfg, torch.from_numpy(toks), tt.init_caches(tcfg, 2, 64, device="cpu"))

    def close(got, want) -> bool:
        if dtype == "float32":
            return _diff(got, want) <= LOGIT_TOL
        return _diff(got, want) <= BF16_LOGIT_REL * float(np.abs(np.asarray(want, np.float32)).max())

    assert t_logits.dtype == torch.float32 and close(t_logits, j_logits)
    j_tok = jnp.argmax(j_logits[:, -1:], axis=-1).astype(jnp.int32)
    for _ in range(3):
        t_tok = torch.from_numpy(np.array(j_tok))
        j_logits, _ = jt.decode_step_logits(jparams, jcfg, j_tok, j_caches)
        j_tok, j_caches = jt.decode_step(jparams, jcfg, j_tok, j_caches)
        t_logits, _ = tt.decode_step_logits(tparams, tcfg, t_tok, t_caches)
        t_next, t_caches = tt.decode_step(tparams, tcfg, t_tok, t_caches)
        assert close(t_logits, j_logits)
        if dtype == "float32":
            assert t_next.tolist() == np.asarray(j_tok).tolist()


@pytest.mark.parametrize("weight_quant", ["none", "int8"])
def test_unembed_product_kept_in_fp32(weight_quant):
    """With no layers the logits are the final norm and the unembed alone:
    the port's equal JAX's within 1e-5 of the largest logit in bf16 (a
    product rounded to bf16 before the fp32 widen differs by ~2.5e-3)."""
    jcfg, tcfg, jparams, tparams = _models("bfloat16", weight_quant, num_layers=0)
    toks = np.random.default_rng(8).integers(0, CFG["vocab_size"], (2, 12)).astype(np.int32)
    j_logits, _ = jt.prefill(jparams, jcfg, jnp.asarray(toks), jt.init_caches(jcfg, 2, 32))
    t_logits, _ = tt.prefill(tparams, tcfg, torch.from_numpy(toks), tt.init_caches(tcfg, 2, 32, device="cpu"))
    want = np.asarray(j_logits, np.float32)
    assert t_logits.dtype == torch.float32
    assert _diff(t_logits, want) <= 1e-5 * float(np.abs(want).max())
