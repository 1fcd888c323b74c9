"""Parity of the PyTorch port's quantized operations with the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode, as tests/test_decode.py and
tests/test_paged.py run them) and through the port's plain versions, which
its wrappers take for CPU tensors. Cache rows are U(-1, 1) scaled per row by
2^U(-4, 4) before they are quantized, so every row has its own scale and a
kernel or a plain version that applied a neighbouring row's scale would
fail. Queries are fp32; the JAX package's quantized kernels take them in
interpret mode.

Tolerances:
  * quantized payloads and scales, page writes: EQUAL (the same per-row
    formula in fp32, rounding half to even, fp8 a plain cast);
  * decode and chunk attention over the same quantized cache: 1e-4 in fp32,
    base-2 LSE 1e-4 (the port scales each row as it loads it, JAX scales the
    scores and p: the same products in another order).

The model steps and both engines on quantized caches and int8 weights are
in tests/test_torch_quant_engine.py.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.ops import decode as jdecode
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax, params_from_jax
from flash_attention_tpu_torch.ops import decode as tdecode
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops import quant as tquant

OP_TOL = 1e-4
LSE_TOL = 1e-4
PAGE = 128
HEAD_DIM = 32
MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)


def _rows(rng, shape):
    """U(-1, 1) rows, each scaled by its own 2^U(-4, 4)."""
    x = rng.uniform(-1, 1, shape) * 2.0 ** rng.uniform(-4, 4, shape[:-1] + (1,))
    return x.astype(np.float32)


def _bits(x) -> np.ndarray:
    """The bytes of a JAX or torch array, for exact comparison (fp8 too)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy() if x.element_size() == 1 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


def _equal(got, want) -> bool:
    return np.array_equal(_bits(got), _bits(want))


def _diff(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), "non-finite entries differ"
    assert np.array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)])
    fin = np.isfinite(got)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def _payload(mode):
    return jquant.payload_dtype(mode), tquant.payload_dtype(mode)


# ---------------------------------------------------------------- quant.py


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_values_matches_jax(mode, dtype):
    x = _rows(np.random.default_rng(0), (4, 8, 256, HEAD_DIM))
    x[0, 0, 0] = 0.0  # an all-zero row takes scale 1
    jp, tp = _payload(mode)
    want = jquant.quantize_values(jnp.asarray(x).astype(dtype), jp)
    got = tquant.quantize_values(torch.from_numpy(x).to(getattr(torch, dtype)), tp)
    assert got.values.dtype == tp and got.scales.dtype == torch.float32
    assert _equal(got.values, want.values) and _equal(got.scales, want.scales)
    assert float(got.scales[0, 0, 0, 0]) == 1.0
    torch.testing.assert_close(tquant.dequantize(got), torch.from_numpy(np.asarray(jquant.dequantize(want))), rtol=0, atol=0)


def test_quantize_weight_and_model_weights_match_jax():
    """Per-output-channel int8 weights of a whole tiny model, and their
    bf16 widen, equal to JAX's (through params_from_jax)."""
    jcfg = jt.ModelConfig(**CFG)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jt.quantize_model_weights(jparams)), device="cpu")
    got = tt.quantize_model_weights(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    w_leaves, g_leaves = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(w_leaves) == len(g_leaves)
    assert all(_equal(g, w) for g, w in zip(g_leaves, w_leaves))
    wo = got["layers"][1]["attn"]["wo"]
    assert isinstance(wo, tquant.QuantizedTensor) and tuple(wo.scales.shape) == (1, 1, 128)
    assert tuple(got["embed"].scales.shape) == (128, 1)
    j_wo = jt.quantize_model_weights(jparams)["layers"][1]["attn"]["wo"]
    assert _equal(tquant.w8_dequant(wo).float(), np.asarray(jquant.w8_dequant(j_wo).astype(jnp.float32)))


def test_params_from_jax_round_trip_quantized():
    """A JAX tree with int8 weights comes across as the port's
    QuantizedTensors with the same bits, and an fp8 dense cache (payload
    and scales) with the same bits."""
    jcfg = jt.ModelConfig(**{**CFG, "weight_quant": "int8", "kv_quant": "fp8_e4m3"})
    jparams = jt.init_model_params(jax.random.key(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert isinstance(tparams["embed"], tquant.QuantizedTensor)
    assert isinstance(tparams["layers"][0]["mlp"]["w_up"], tquant.QuantizedTensor)
    assert tparams["layers"][0]["mlp"]["w_up"].values.dtype == torch.int8
    for j, t in zip(jax.tree.leaves(jparams), jax.tree.leaves(tparams)):
        assert _equal(t, j)
    acfg = jcfg.attention_config()
    jc = jattn.init_kv_cache(acfg, 2, 64)
    k = jnp.asarray(_rows(np.random.default_rng(2), (2, 2, 8, HEAD_DIM)))
    jc = jattn.write_cache(acfg, jc, k, -k, jnp.asarray([0, 3], jnp.int32))
    tc = kv_cache_from_jax(jc, device="cpu")
    assert tc.k.dtype == torch.float8_e4m3fn and tc.quantized()
    for name in ("k", "v", "k_scales", "v_scales", "lengths"):
        assert _equal(getattr(tc, name), getattr(jc, name)), name


# ---------------------------------------------------------------- kernels' functions


@pytest.mark.parametrize("mode", MODES)
def test_decode_attention_quantized_matches_jax(mode):
    """K6's function on QuantizedTensor caches ([B, Hkv, S, 1] scales):
    output and LSE, with an empty slot and a full one."""
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 1, (4, 8, HEAD_DIM)).astype(np.float32) * 4
    k, v = _rows(rng, (4, 2, 256, HEAD_DIM)), _rows(rng, (4, 2, 256, HEAD_DIM))
    lengths = np.array([0, 1, 100, 256], np.int32)
    jk, jv = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), mode)
    tk, tv = (params_from_jax(jax.tree.map(np.asarray, x), device="cpu") for x in (jk, jv))
    assert isinstance(tk, tquant.QuantizedTensor) and tuple(tk.scales.shape) == (4, 2, 256, 1)
    want, want_lse = jdecode.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lengths), save_residuals=True)
    got, got_lse = tdecode.decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(lengths), save_residuals=True)
    assert _diff(got, want) <= OP_TOL and _diff(got_lse, want_lse) <= LSE_TOL
    assert bool((got[0] == 0).all())


def _quant_pages(seed, mode, *, num_slots, pages_per_slot, lengths, kv_heads=2):
    """The same filled quantized paged cache as a JAX and a port
    PagedKVCache, over a shuffled table whose slot 0 is on dump page 0."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + num_slots * pages_per_slot
    k = _rows(rng, (num_pages, kv_heads, PAGE, HEAD_DIM))
    v = _rows(rng, (num_pages, kv_heads, PAGE, HEAD_DIM))
    table = rng.permutation(np.arange(1, num_pages))[: num_slots * pages_per_slot]
    table = table.reshape(num_slots, pages_per_slot).astype(np.int32)
    table[0] = 0
    (kq, ks), (vq, vs) = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), mode)
    j = jpaged.PagedKVCache(kq, vq, jnp.asarray(table), jnp.asarray(lengths, jnp.int32),
                            jnp.swapaxes(ks, 2, 3), jnp.swapaxes(vs, 2, 3))
    return j, kv_cache_from_jax(j, device="cpu")


def _assert_pages_equal(tc, jc, scale_ulps=0):
    for name in ("k_pages", "v_pages", "page_table", "lengths"):
        assert _equal(getattr(tc, name), getattr(jc, name)), name
    for name in ("k_scales", "v_scales"):
        got, want = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))[:, :, 0]
        assert np.all(np.abs(got - want) <= scale_ulps * np.spacing(want)), name


@pytest.mark.parametrize("mode", MODES)
def test_paged_decode_quantized_matches_jax(mode):
    """K7's function on quantized pages: output and base-2 LSE."""
    jc, tc = _quant_pages(4, mode, num_slots=4, pages_per_slot=4, lengths=[0, 1, 200, 4 * PAGE])
    q = np.random.default_rng(5).uniform(-1, 1, (4, 8, HEAD_DIM)).astype(np.float32) * 4
    want, want_lse = jpaged.paged_decode_attention(jnp.asarray(q), jc, save_residuals=True)
    got, got_lse = tpaged.paged_decode_attention(torch.from_numpy(q), tc, save_residuals=True)
    assert _diff(got, want) <= OP_TOL and _diff(got_lse, want_lse) <= LSE_TOL


@pytest.mark.parametrize("mode", MODES)
def test_paged_prefill_quantized_matches_jax(mode):
    """K8's function on quantized pages: a 256-row chunk ending at 512."""
    jc, tc = _quant_pages(6, mode, num_slots=2, pages_per_slot=4, lengths=[0, 512])
    q = np.random.default_rng(7).uniform(-1, 1, (1, 8, 256, HEAD_DIM)).astype(np.float32) * 4
    want = jpaged.paged_prefill_attention(jnp.asarray(q), jc, 1, 512, chunk_len=256)
    got = tpaged.paged_prefill_attention(torch.from_numpy(q), tc, 1, 512, chunk_len=256)
    assert _diff(got, want) <= OP_TOL
    k, v = tpaged.paged_gather_kv(tc, 1, 256)
    want_k, want_v = jpaged.paged_gather_kv(jc, 1, 256)
    assert k.dtype == torch.bfloat16 and _equal(k.float(), np.asarray(want_k.astype(jnp.float32)))
    assert _equal(v.float(), np.asarray(want_v.astype(jnp.float32)))


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_paged_write_tokens_quantized_matches_jax(mode, layers):
    """K9q (one layer, ``paged_write_tokens``) and K10q (three layers of one
    model cache): payload rows and scales EQUAL to JAX's, a page boundary,
    a slot at capacity (nothing written, length frozen), the dump slot."""
    lengths = [5, 127, 4 * PAGE, 128]
    j_caches, t_caches = zip(*(_quant_pages(8 + i, mode, num_slots=4, pages_per_slot=4, lengths=lengths)
                              for i in range(layers)))
    j_caches = [c._replace(page_table=j_caches[0].page_table) for c in j_caches]
    rng = np.random.default_rng(11)
    k_new, v_new = _rows(rng, (layers, 4, 2, HEAD_DIM)), _rows(rng, (layers, 4, 2, HEAD_DIM))
    slots = np.array([3, 0, 2, 1], np.int32)
    if layers == 1:
        want = [jpaged.paged_write_tokens(j_caches[0], jnp.asarray(k_new[0]), jnp.asarray(v_new[0]), jnp.asarray(slots))]
        got = [tpaged.paged_write_tokens(t_caches[0], torch.from_numpy(k_new[0]), torch.from_numpy(v_new[0]),
                                         torch.from_numpy(slots))]
    else:
        want = jpaged.paged_write_tokens_multi(j_caches, list(map(jnp.asarray, k_new)), list(map(jnp.asarray, v_new)),
                                               jnp.asarray(slots))
        model = tpaged.PagedModelCache(
            *(torch.stack([getattr(c, n) for c in t_caches]) for n in ("k_pages", "v_pages")),
            t_caches[0].page_table, t_caches[0].lengths,
            *(torch.stack([getattr(c, n) for c in t_caches]) for n in ("k_scales", "v_scales")),
        )
        got = tpaged.paged_write_tokens_multi(model, torch.from_numpy(k_new), torch.from_numpy(v_new),
                                              torch.from_numpy(slots)).layers()
    for tc, jc in zip(got, want):
        _assert_pages_equal(tc, jc)
        assert tc.lengths.tolist() == [6, 128, 4 * PAGE, 129]


@pytest.mark.parametrize("mode", MODES)
def test_paged_write_prefill_quantized_matches_jax(mode):
    """Two pages of rows at logical [128, 384) of slot 1, quantized per row
    (JAX quantizes page by page in a scan): payload EQUAL, scales within one
    unit in the last place. Under jit (the scan) XLA rewrites JAX's
    ``absmax / 127.0`` into ``absmax * (1 / 127)``, which rounds differently
    for some rows; the port divides, as JAX's eager ``quantize_values`` and
    its other page writes do (ROADMAP.md queue 4)."""
    jc, tc = _quant_pages(12, mode, num_slots=3, pages_per_slot=4, lengths=[0, 0, 0])
    rng = np.random.default_rng(13)
    k_new, v_new = _rows(rng, (2, 256, HEAD_DIM)), _rows(rng, (2, 256, HEAD_DIM))
    want = jpaged.paged_write_prefill(jc, jnp.asarray(k_new), jnp.asarray(v_new), 1, 300, start=128)
    got = tpaged.paged_write_prefill(tc, torch.from_numpy(k_new), torch.from_numpy(v_new), 1, 300, start=128)
    _assert_pages_equal(got, want, scale_ulps=1)
    # Against JAX's eager quantize_values, the definition, the scales are equal.
    rows = np.asarray(jnp.asarray(k_new))
    want_k = jquant.quantize_values(jnp.asarray(rows), _payload(mode)[0])
    phys = np.asarray(jc.page_table)[1, 1:3]
    got_k = got.k_scales[torch.from_numpy(phys).long()].transpose(0, 1).reshape(2, 256, 1)
    assert _equal(got_k, want_k.scales)


# ---------------------------------------------------------------- what the port reads

PORT = pathlib.Path(__file__).resolve().parents[1] / "flash_attention_tpu_torch"


def test_port_names_no_path_or_module_of_the_jax_package():
    """No source of the port, nor chip_smoke.py, names a path under the JAX
    package's directory or one of its modules (the port's own name,
    flash_attention_tpu_torch, is not one)."""
    named = re.compile(r"flash_attention_tpu(?=[/.])|(?:import|from)\s+flash_attention_tpu\b(?!_)")
    files = [p for ext in ("py", "cu", "cuh", "cpp") for p in PORT.rglob(f"*.{ext}")]
    files.append(PORT.parent / "chip_smoke.py")
    assert len(files) > 30
    hits = [f"{p.name}:{i}" for p in files for i, line in enumerate(p.read_text().splitlines(), 1) if named.search(line)]
    assert not hits, hits
    assert named.search("x = 'flash_attention_tpu/ops'") and named.search("import flash_attention_tpu")
    assert not named.search("from flash_attention_tpu_torch.ops import quant; flash_attention_tpu_torch/csrc")


def test_native_build_reads_only_the_ports_sources(monkeypatch):
    """The scheduler, allocator and oracle compile from the port's own copy
    under flash_attention_tpu_torch/native/src."""
    from flash_attention_tpu_torch import native

    seen = []
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build_shared", lambda stem, sources, *a, **k: seen.extend(sources) or 1 / 0)
    with pytest.raises(ZeroDivisionError):
        native.load()
    assert [p.name for p in seen] == ["scheduler.cpp", "oracle.cpp", "allocator.cpp"]
    assert all(p.parent == PORT / "native" / "src" and p.is_file() for p in seen)
