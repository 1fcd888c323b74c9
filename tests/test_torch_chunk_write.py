"""A prefill chunk's RoPE and cache write (``ops.fused.rope_chunk``, F2c on the
card; its plain version on the CPU) against the JAX package.

At ``ModelConfig.tiny()``'s widths (8 q / 4 kv heads, head_dim 32) and
chunks of 64 and 128 rows, numpy-seeded rows go through the wrapper's CPU
route into a cache of three slots whose rows all hold distinct random
values (random payloads and scales for a quantized cache), at slot 0 as a
host int and at the last slot as a device-style tensor:

  * the rotation: q and the rotated k against JAX's ``apply_rope`` within
    1e-6 of the largest |x| in fp32 (torch's and XLA's cos / sin each round
    within an ulp) and 1 ulp in bf16; q equal to the port's ``apply_rope``;
  * the dense cache (16-bit, int8 / e4m3 / e5m2, the rolling ring with a
    chunk that wraps its end, the ring with 4 sinks): every tensor of the
    cache, the other slots' rows included, and the lengths exactly equal
    to the cache JAX's ``attention_prefill_chunk`` leaves (its Pallas
    kernels in interpret mode), JAX's rotation pinned to the port's rows so
    that the write itself is compared bit for bit;
  * the page pool (16-bit and quantized, pages of 16 rows over a shuffled
    table whose chunk span holds the dump page 0 and an id past the pool,
    clamped to its last page): against JAX's ``paged_write_prefill`` of the same
    rotated rows, tables and lengths equal, scales within 1 ulp (inside
    its jitted scan XLA turns the scale's division into a multiply, which
    can move a scale by one ulp) and payloads equal wherever the scales
    are, every written row's payload and scale equal to JAX's eager
    ``quantize_values`` of the same rows (the form the port follows); a
    row whose scale is one ulp off can round an fp8 code differently in
    JAX's jitted write.

Also the wrapper's refusals, which both routes share, and that the CPU route
launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import rope as jrope
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import rope as trope
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax
from flash_attention_tpu_torch.ops import counters, fused
from flash_attention_tpu_torch.ops import paged as tpaged

HQ, HKV, D, MODEL = 8, 4, 32, 256  # ModelConfig.tiny()'s attention widths
SLOTS = 3
THETA = 10000.0
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}

# (AttentionConfig fields, max_seq, chunk start, chunk length)
DENSE = {
    "bfloat16": (dict(dtype="bfloat16"), 256, 64, 128),
    "float32": (dict(dtype="float32"), 256, 128, 64),
    "int8": (dict(dtype="bfloat16", kv_quant="int8"), 256, 192, 64),
    "fp8_e4m3": (dict(dtype="bfloat16", kv_quant="fp8_e4m3"), 256, 0, 64),
    "fp8_e5m2": (dict(dtype="float32", kv_quant="fp8_e5m2"), 256, 128, 128),
    # A 256-row ring (window 100 + chunk 64, 128-aligned): [224, 288) wraps its end.
    "rolling": (dict(dtype="bfloat16", sliding_window=100, rolling=True), 1024, 224, 64),
    "rolling int8": (dict(dtype="bfloat16", sliding_window=100, rolling=True, kv_quant="int8"), 1024, 480, 64),
    # 4 sinks in 128 padded rows before a 256-row ring: the first chunk straddles the sinks.
    "rolling + sinks": (dict(dtype="float32", sliding_window=100, rolling=True, attention_sinks=4), 1024, 0, 64),
    "rolling + sinks wrap": (dict(dtype="bfloat16", sliding_window=100, rolling=True, attention_sinks=4), 1024,
                             228, 64),
}
PAGE, PAGES_PER_SLOT = 16, 8
NUM_PAGES = 2 + SLOTS * PAGES_PER_SLOT  # the dump page 0, the slots' pages, and the last, reached by the clamp
# (dtype, kv_quant, chunk start, chunk length)
PAGED = {
    "bfloat16": ("bfloat16", "none", 32, 64),
    "float32": ("float32", "none", 0, 128),
    "int8": ("bfloat16", "int8", 64, 64),
    "fp8_e4m3": ("float32", "fp8_e4m3", 32, 64),
    "fp8_e5m2": ("bfloat16", "fp8_e5m2", 0, 128),
}


def _pair(x: np.ndarray, name: str):
    """x (fp32 numpy) rounded to ``name``: the same values as a torch tensor and a JAX array."""
    tdt, jdt = DTYPES[name]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _jax(t: torch.Tensor, name: str):
    return jnp.asarray(t.float().numpy(), DTYPES[name][1])


def _rows(rng, shape) -> np.ndarray:
    """Rows of distinct magnitudes (each row scaled by 2^U(-3, 3)), so a row quantized with another's scale shows."""
    return (rng.normal(size=shape) * np.exp2(rng.uniform(-3, 3, size=shape[:-1] + (1,)))).astype(np.float32)


def _slots(last_as_tensor: bool):
    """(the slot as the wrapper takes it, its index): 0 as a host int, or the last slot as a [1] int32 tensor."""
    return (torch.tensor([SLOTS - 1], dtype=torch.int32), SLOTS - 1) if last_as_tensor else (0, 0)


def _chunk(rng, name: str, t: int):
    """Un-rotated q, k, v of one chunk, as torch tensors and JAX arrays."""
    return [_pair(_rows(rng, (1, h, t, D)), name) for h in (HQ, HKV, HKV)]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.uint8).numpy() if x.element_size() == 1 else x.float().numpy()


def _dense_caches(fields: dict, rows: int, rng):
    """A JAX cache of SLOTS x ``rows`` rows, every slot distinct (quantized
    by the JAX package's quantizer for a kv_quant config) with distinct
    lengths, and the port's copy of it."""
    shape = (SLOTS, HKV, rows, D)
    mode, jdt = fields.get("kv_quant", "none"), DTYPES[fields["dtype"]][1]
    k, v = _rows(rng, shape), _rows(rng, shape)
    lengths = jnp.asarray([3, 17, 41], jnp.int32)
    if mode == "none":
        jc = jattn.KVCache(k=jnp.asarray(k, jdt), v=jnp.asarray(v, jdt), lengths=lengths, k_scales=None,
                           v_scales=None)
    else:
        qk, qv = (jquant.quantize_values(jnp.asarray(x), jquant.payload_dtype(mode)) for x in (k, v))
        jc = jattn.KVCache(k=qk.values, v=qv.values, lengths=lengths, k_scales=qk.scales, v_scales=qv.scales)
    return jc, kv_cache_from_jax(jc, device="cpu")


def _rotated(x: torch.Tensor, start: int) -> torch.Tensor:
    return trope.apply_rope(x, start + torch.arange(x.shape[2])[None, None, :], theta=THETA)


def _assert_rotation(got: torch.Tensor, x_j, start: int, name: str) -> None:
    """``got`` (the port's rotation of x) within 1e-6 of the largest |x| in fp32, 1 bf16 ulp in bf16, of JAX's."""
    want = np.asarray(jrope.apply_rope(x_j, start + jnp.arange(x_j.shape[2])[None, None, :], theta=THETA),
                      np.float32)
    g = got.float().numpy()
    if name == "float32":
        assert np.abs(g - want).max() <= 1e-6 * np.abs(want).max()
    else:
        ordered = [np.where(b & 0x8000, -(b & 0x7FFF), b & 0x7FFF)
                   for b in (a.view(np.uint32).astype(np.int64) >> 16 for a in (g, want))]
        assert np.abs(ordered[0] - ordered[1]).max() <= 1


@pytest.mark.parametrize("last", [False, True], ids=["slot 0", "last slot tensor"])
@pytest.mark.parametrize("case", list(DENSE))
def test_dense_chunk_write_matches_jax(case, last, monkeypatch):
    fields, max_seq, start, t = DENSE[case]
    jcfg = jattn.AttentionConfig(model_dim=MODEL, num_q_heads=HQ, num_kv_heads=HKV, head_dim=D, **fields)
    tcfg = tattn.AttentionConfig(model_dim=MODEL, num_q_heads=HQ, num_kv_heads=HKV, head_dim=D, **fields)
    rows = tattn.rolling_buffer_len(tcfg, max_seq, t) if tcfg.rolling else max_seq
    name = fields["dtype"]
    rng = np.random.default_rng(sum(map(ord, case)) + last)
    jc, tc = _dense_caches(fields, rows, rng)
    (q, q_j), (k, k_j), (v, v_j) = _chunk(rng, name, t)
    slot, index = _slots(last)
    got_q, got = fused.rope_chunk(q, k, v, tc, slot, start, theta=THETA, ring=tcfg.rolling,
                                  sinks=tcfg.attention_sinks)
    assert got.lengths is not tc.lengths  # replaced, not mutated
    assert torch.equal(got_q, _rotated(q, start))
    _assert_rotation(got_q, q_j, start, name)
    k_rot = _rotated(k, start)
    _assert_rotation(k_rot, k_j, start, name)
    # JAX's chunk step writes the same rotated rows: its projection pinned to the port's rotation.
    monkeypatch.setattr(jattn, "_project_qkv", lambda *a, **kw: (_jax(got_q, name), _jax(k_rot, name), v_j))
    x = jnp.zeros((1, t, MODEL), DTYPES[name][1])
    params = jattn.init_attention_params(jax.random.key(0), jcfg)  # its wo projects the chunk's output
    _, want = jattn.attention_prefill_chunk(params, jcfg, x, jc, index, start, start + t)
    want = kv_cache_from_jax(want, device="cpu")
    for field in ("k", "v", "k_scales", "v_scales", "lengths"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), field
    assert got.lengths.tolist()[index] == start + t


def _paged_caches(dtype: str, mode: str, rng):
    """A JAX paged cache of NUM_PAGES filled pages (random payloads and
    scales when quantized) under a shuffled table whose slots' spans hold
    the dump page 0 and an id past the pool, and the port's copy."""
    jc = jpaged.init_paged_cache(num_pages=NUM_PAGES, num_slots=SLOTS, pages_per_slot=PAGES_PER_SLOT, kv_heads=HKV,
                                 page_size=PAGE, head_dim=D, dtype=DTYPES[dtype][1], kv_quant=mode)
    table = rng.permutation(np.arange(1, NUM_PAGES - 1)).reshape(SLOTS, PAGES_PER_SLOT).astype(np.int32)
    table[:, 3], table[:, 5] = NUM_PAGES + 4, 0  # clamped to the pool's last page; the dump page
    fill = {}
    for name in ("k_pages", "v_pages"):
        x = _rows(rng, jc.k_pages.shape)
        if mode == "none":
            fill[name] = jnp.asarray(x, DTYPES[dtype][1])
        else:
            qt = jquant.quantize_values(jnp.asarray(x), jquant.payload_dtype(mode))
            fill[name] = qt.values
            fill[name[0] + "_scales"] = jnp.swapaxes(qt.scales, 2, 3)  # [P, H, 1, page]
    jc = jc._replace(**fill, page_table=jnp.asarray(table), lengths=jnp.asarray([5, 9, 2], jnp.int32))
    return jc, kv_cache_from_jax(jc, device="cpu")


@pytest.mark.parametrize("last", [False, True], ids=["slot 0", "last slot tensor"])
@pytest.mark.parametrize("case", list(PAGED))
def test_paged_chunk_write_matches_jax(case, last):
    dtype, mode, start, t = PAGED[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 7 * last)
    jc, tc = _paged_caches(dtype, mode, rng)
    (q, q_j), (k, k_j), (v, v_j) = _chunk(rng, dtype, t)
    slot, index = _slots(last)
    got_q, got = fused.rope_chunk(q, k, v, tc, slot, start, theta=THETA)
    assert torch.equal(got_q, _rotated(q, start))
    _assert_rotation(got_q, q_j, start, dtype)
    k_rot = _rotated(k, start)
    want = jpaged.paged_write_prefill(jc, _jax(k_rot, dtype)[0], v_j[0], index, start + t, start=start)
    want = kv_cache_from_jax(want, device="cpu")
    for field in ("page_table", "lengths") + (("k_pages", "v_pages") if mode == "none" else ()):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), field
    if mode != "none":
        phys = np.clip(np.asarray(jc.page_table)[index, start // PAGE:(start + t) // PAGE], 0, NUM_PAGES - 1)
        for name, new in (("k", k_rot), ("v", v)):
            pages, scales = getattr(got, f"{name}_pages"), getattr(got, f"{name}_scales")
            w_pages, w_scales = getattr(want, f"{name}_pages"), getattr(want, f"{name}_scales")
            ulps = np.abs(scales.numpy().view(np.int32).astype(np.int64) - w_scales.numpy().view(np.int32))
            assert ulps.max() <= 1, name
            same = (ulps == 0)[..., None]
            assert pages.dtype == w_pages.dtype
            assert np.array_equal(np.where(same, _bits(pages), 0), np.where(same, _bits(w_pages), 0)), name
            # The chunk's rows, read back through the table, are JAX's eager quantizer's to the bit.
            eager = jquant.quantize_values(_jax(new, dtype)[0], jquant.payload_dtype(mode))
            rows = pages[phys].transpose(0, 1).reshape(HKV, t, D)
            row_scales = scales[phys].transpose(0, 1).reshape(HKV, t, 1)
            want_rows = kv_cache_from_jax(jattn.KVCache(eager.values, eager.values, None, None, eager.scales[:1]),
                                          device="cpu").k
            assert np.array_equal(_bits(rows), _bits(want_rows)), name
            assert np.array_equal(row_scales.numpy(), np.asarray(eager.scales)), name
    assert got.lengths.tolist()[index] == start + t
    # The port's own page write (``paged_write_prefill``) is the same function of the rotated rows.
    again = tpaged.paged_write_prefill(kv_cache_from_jax(jc, device="cpu"), k_rot[0], v[0], slot, start + t,
                                       start=start)
    for a, b in zip(got, again):
        assert (a is None) == (b is None) and (a is None or np.array_equal(_bits(a), _bits(b)))


def _refused(cache, q, k, v, start, match, **kw):
    with pytest.raises(ValueError, match=match):
        fused.rope_chunk(q, k, v, cache, 0, start, **kw)


def test_the_wrapper_refuses_what_no_route_takes():
    rng = np.random.default_rng(3)
    _, dense = _dense_caches(dict(dtype="float32"), 128, rng)
    (q, _), (k, _), (v, _) = _chunk(rng, "float32", 64)
    _refused(dense, q, k, v, 96, r"rows \[96, 160\) of a dense cache of 128")
    _refused(dense, q, k, v, 0, "sinks without a ring", sinks=4)
    _refused(dense, torch.cat([q, q]), k, v, 0, "one sequence")
    _refused(dense, q, k[:, :2], v, 0, "one sequence")
    _refused(dense, q, k, v, 0, "holds no 64 rows apart", ring=True, sinks=100)  # 128 rows, all of them sinks
    _, paged = _paged_caches("float32", "none", rng)
    _refused(paged, q, k, v, 8, "whole 16-row pages")
    _refused(paged, q, k, v, 96, "within the slot's 8")
    _refused(paged, q, k, v, 0, "takes no ring", ring=True)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="runs on cpu or cuda tensors"):
        fused.rope_chunk(*meta, dense, 0, 0)


def test_the_cpu_route_launches_nothing():
    rng = np.random.default_rng(4)
    _, dense = _dense_caches(dict(dtype="bfloat16", kv_quant="int8"), 128, rng)
    (q, _), (k, _), (v, _) = _chunk(rng, "bfloat16", 64)
    counters.zero()
    fused.rope_chunk(q, k, v, dense, torch.tensor([1], dtype=torch.int32), 64)
    assert counters.read()["F2c"] == 0 and counters.read()["F2"] == 0
