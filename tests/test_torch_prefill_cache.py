"""A prefill chunk's attention over its cache where it lies: ``cache_attention``
(K1q over a quantized dense cache, K1r over the rolling ring; their plain
version on the CPU) and the chunk prefill through it, against the JAX package.

The layer tests run the JAX package's ``attention_prefill_chunk`` as
tests/test_torch_masks_layer.py does (its Pallas kernels in interpret mode)
and the port's on the CPU, where ``cache_attention`` runs its plain version:
the same numpy-seeded parameters, chunks and starting caches, every slot of
which holds distinct rows (random payloads and scales for a quantized
cache), the port's slot a tensor. The direct tests hold ``cache_attention``
to an fp32 oracle over the logical positions a chunk sees, built here from
the positions and not from the ring's layout; the walk tests hold the
kernel's ring walk (``fwd_walk(ring=True)``, each tile from ``ring_rows``' row
of its first position) to the rows
the cache writes. The bf16 output projection is held to JAX's fp32-summed
einsum within bf16's rounding, the fp32 one to the einsum bit for bit.

Tolerances: fp32 1e-5 (the same sums in another order); bf16 one rounding
of an fp32 sum (2^-8 of the value); lengths equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.ops.common import ring_rows
from flash_attention_tpu_torch.ops.flash_attention import (
    KV_TILE,
    cache_attention,
    cache_attention_plain,
    fwd_walk,
)
from flash_attention_tpu_torch.ops.quant import bits

FP32_TOL = 1e-5
ATTN = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")
SLOTS = 3
SLOT = 1
TORCH_PAYLOADS = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


def _torch_payload(arr, mode: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if mode == "int8":
        return torch.from_numpy(arr.copy())
    return torch.from_numpy(arr.view(np.uint8).copy()).view(TORCH_PAYLOADS[mode])


def _caches(cfg: dict, rows: int, rng):
    """A JAX and a port cache of SLOTS slots x ``rows`` rows holding the same
    random rows in every slot (quantized by the JAX package's quantizer for
    a kv_quant config), with lengths 0."""
    shape = (SLOTS, ATTN["num_kv_heads"], rows, ATTN["head_dim"])
    mode = cfg.get("kv_quant", "none")
    k, v = (rng.normal(size=shape).astype(np.float32) * np.exp2(rng.uniform(-3, 3, size=shape[:3] + (1,)))
            for _ in range(2))
    lengths = np.zeros((SLOTS,), np.int32)
    if mode == "none":
        jc = jattn.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), k_scales=None, v_scales=None,
                           lengths=jnp.asarray(lengths))
        tc = tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lengths))
        return jc, tc
    qk, qv = (jquant.quantize_values(jnp.asarray(x), jquant.payload_dtype(mode)) for x in (k, v))
    jc = jattn.KVCache(k=qk.values, v=qv.values, k_scales=qk.scales, v_scales=qv.scales, lengths=jnp.asarray(lengths))
    tc = tattn.KVCache(_torch_payload(qk.values, mode), _torch_payload(qv.values, mode), torch.from_numpy(lengths),
                       torch.from_numpy(np.array(qk.scales)), torch.from_numpy(np.array(qv.scales)))
    return jc, tc


def _to_port(jc, mode: str):
    """A JAX cache as the port's (the rows bit for bit)."""
    if mode == "none":
        return tattn.KVCache(*(torch.from_numpy(np.array(x)) for x in (jc.k, jc.v, jc.lengths)))
    return tattn.KVCache(_torch_payload(jc.k, mode), _torch_payload(jc.v, mode), torch.from_numpy(np.array(jc.lengths)),
                         *(torch.from_numpy(np.array(x)) for x in (jc.k_scales, jc.v_scales)))


def _run_chunks(fields: dict, rows_seq: int, chunks, *, seed: int) -> tuple[int, int]:
    """The chunks (lengths, in order from position 0) of one sequence into
    slot SLOT of the same random caches through JAX's layer and through
    the port's. Each chunk twice: ``cache_attention`` over JAX's cache as
    JAX's chunk left it (its own rows written), on the port's q and through
    the port's output projection, within FP32_TOL of JAX's output; and the
    port's whole layer on its own cache, within FP32_TOL (quantized too:
    both packages quantize the chunk's rows to the same codes), the
    lengths equal."""
    jcfg, tcfg = jattn.AttentionConfig(**ATTN, **fields), tattn.AttentionConfig(**ATTN, **fields)
    jp = jattn.init_attention_params(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    rows = rows_seq
    if fields.get("rolling"):
        rows = tattn.rolling_buffer_len(tcfg, rows_seq, max(chunks))
    jc, tc = _caches(fields, rows, rng)
    mode = fields.get("kv_quant", "none")
    slot = torch.tensor([SLOT], dtype=torch.int32)  # the port's slot as a tensor, as the prefill programs keep it
    start = 0
    for t in chunks:
        x = rng.normal(size=(1, t, ATTN["model_dim"])).astype(np.float32)
        xt = torch.from_numpy(x)
        j_out, jc = jattn.attention_prefill_chunk(jp, jcfg, jnp.asarray(x), jc, SLOT, start, start + t)
        on_jax = _to_port(jc, mode)
        q, _, _ = tattn._project_qkv(tp, tcfg, xt, start + torch.arange(t)[None, None, :])
        o = cache_attention(q, on_jax.k, on_jax.v, slot, start + t, k_scales=on_jax.k_scales,
                            v_scales=on_jax.v_scales, ring=tcfg.rolling, sinks=tcfg.attention_sinks,
                            sliding_window=tcfg.sliding_window, logit_softcap=tcfg.logit_softcap)
        d = _diff(tattn._output_proj(tp, o, torch.float32), j_out)
        assert d <= FP32_TOL, f"cache_attention, chunk [{start}, {start + t}): {d}"
        t_out, tc = tattn.attention_prefill_chunk(tp, tcfg, xt, tc, slot, start, start + t)
        d = _diff(t_out, j_out)
        assert d <= FP32_TOL, f"layer, chunk [{start}, {start + t}): {d}"
        assert np.array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        start += t
    return rows, start


# ---------------------------------------------------------------- the chunk over a quantized dense cache (K1q)


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_dense_chunks_match_jax(mode):
    """Chunks of 64 and 32 rows into slot 1 of a 3-slot int8 / e4m3 / e5m2
    cache whose slots all hold distinct rows, up to the cache's 160 rows,
    each chunk attending the slot's dequantized prefix."""
    rows, end = _run_chunks(dict(kv_quant=mode), 160, (64, 32, 64), seed=5)
    assert end == rows


# ---------------------------------------------------------------- the chunk over the rolling ring (K1r)


@pytest.mark.parametrize("fields,chunks", [
    # window 96, a ring of 256 rows: kv_end 128 (below the rows), 256 (at), then past; [448, 544) wraps its end.
    (dict(sliding_window=96), (128, 128, 96, 96, 96)),
    # 4 sinks, window 192, 384 ring rows after the sinks' 128: before and past the window; [320, 448) wraps.
    (dict(sliding_window=192, attention_sinks=4), (128, 64, 128, 128)),
    # 32 sinks: before and past the window.
    (dict(sliding_window=192, attention_sinks=32), (128, 160)),
    # an int8 payload with 4 sinks, wrapping.
    (dict(sliding_window=192, attention_sinks=4, kv_quant="int8"), (128, 128, 128, 64)),
])
def test_ring_chunks_match_jax(fields, chunks):
    """The ring's chunks through both layers from random rings whose slots
    all differ, kv_end passing the window and the ring's rows."""
    rows, end = _run_chunks(dict(rolling=True, **fields), 2048, chunks, seed=7)
    assert end > fields["sliding_window"]


# ---------------------------------------------------------------- cache_attention against an oracle


def _oracle(q, k, v, slot: int, kv_end: int, *, window, sinks: int, ring: bool, softcap=None, scales=None):
    """fp32 attention of q [1, Hq, T, D] at positions [kv_end - T, kv_end)
    over the positions it may see, each read from the row the cache keeps it
    in (the position itself, or on the ring p % rows, with sinks p below
    them and 128-padded sink rows + (p - sinks) % the rest above), under the
    causal, window and sinks mask: (out, base-2 LSE)."""
    t, rows, d = q.shape[2], k.shape[2], q.shape[3]
    lo = 0 if window is None else max(0, kv_end - t - window + 1)
    positions = sorted(set(range(lo, kv_end)) | set(range(min(sinks, kv_end))))
    pad = -(-sinks // 128) * 128 if sinks else 0

    def row_of(p):
        if not ring:
            return p
        return p if p < sinks else pad + (p - sinks) % (rows - pad)

    idx = [row_of(p) for p in positions]
    kf, vf = k[slot][:, idx].float(), v[slot][:, idx].float()
    if scales is not None:
        kf, vf = kf * scales[0][slot][:, idx], vf * scales[1][slot][:, idx]
    group = q.shape[1] // k.shape[1]
    kf, vf = kf.repeat_interleave(group, 0), vf.repeat_interleave(group, 0)
    s = torch.einsum("htd,hpd->htp", q[0].double(), kf.double()) / d ** 0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.tensor(positions)[None, :]
    row = torch.arange(t)[:, None] + kv_end - t
    ok = (pos <= row) & ((pos > row - window) | (pos < sinks) if window is not None else True)
    s = torch.where(ok, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    out = (torch.einsum("htp,hpd->htd", p, vf.double()) / p.sum(-1, keepdim=True))[None]
    lse = ((m[..., 0] + torch.log(p.sum(-1))) / np.log(2))[None]
    return out.float(), lse.float()


@pytest.mark.parametrize("sinks", [0, 4, 32])
@pytest.mark.parametrize("kv_end", [64, 160, 256, 300, 384, 513, 1000])
def test_ring_cache_attention_against_the_oracle(sinks, kv_end):
    """cache_attention over a ring of 256 rows after the sinks' (window 96,
    chunk 64) at kv_end below, at and past the rows, with the LSE: within
    FP32_TOL of the oracle over the logical positions, with 0, 4 and 32
    sinks (past the window the plain version merges two passes)."""
    gen = torch.Generator().manual_seed(kv_end + sinks)
    rows = 256 + (128 if sinks else 0)
    k, v = (torch.rand((SLOTS, 2, rows, 32), generator=gen) - 0.5 for _ in range(2))
    q = torch.rand((1, 4, 64, 32), generator=gen) - 0.5
    slot = torch.tensor([2], dtype=torch.int32)
    out, lse = cache_attention(q, k, v, slot, kv_end, ring=True, sinks=sinks, sliding_window=96, save_residuals=True)
    o_out, o_lse = _oracle(q, k, v, 2, kv_end, window=96, sinks=sinks, ring=True)
    assert _diff(out, o_out) <= FP32_TOL and _diff(lse, o_lse) <= FP32_TOL


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("ring", [False, True])
def test_quantized_cache_attention_against_the_oracle(mode, ring):
    """cache_attention over a quantized slot (dense at kv_end 200 of 256
    rows, or a ring with 4 sinks at kv_end 700) with a softcap of 5: within
    FP32_TOL of the oracle on the dequantized rows; other slots unread."""
    gen = torch.Generator().manual_seed(11)
    rows = 384 if ring else 256
    x = [(torch.rand((SLOTS, 2, rows, 32), generator=gen) - 0.5) * 4 for _ in range(2)]
    (kp, ks), (vp, vs) = (tattn.quantize_values(t, TORCH_PAYLOADS[mode]) for t in x)
    q = torch.rand((1, 4, 64, 32), generator=gen) - 0.5
    kv_end, kw = (700, dict(ring=True, sinks=4, sliding_window=96)) if ring else (200, {})
    out, lse = cache_attention(q, kp, vp, 0, kv_end, k_scales=ks, v_scales=vs, logit_softcap=5.0,
                               save_residuals=True, **kw)
    o_out, o_lse = _oracle(q, kp, vp, 0, kv_end, window=kw.get("sliding_window"), sinks=kw.get("sinks", 0),
                           ring=ring, softcap=5.0, scales=(ks, vs))
    assert _diff(out, o_out) <= FP32_TOL and _diff(lse, o_lse) <= FP32_TOL
    # A slot's rows alone: changing another slot moves nothing.
    bits(kp)[1].zero_()
    assert torch.equal(cache_attention(q, kp, vp, 0, kv_end, k_scales=ks, v_scales=vs, logit_softcap=5.0, **kw), out)


def test_plain_version_is_cache_attentions_cpu_path():
    """On the CPU cache_attention is its plain version, whatever the form;
    the slot may be a host int or a tensor."""
    gen = torch.Generator().manual_seed(3)
    k, v = (torch.rand((SLOTS, 2, 256, 32), generator=gen) - 0.5 for _ in range(2))
    q = torch.rand((1, 4, 64, 32), generator=gen) - 0.5
    for kw in (dict(), dict(ring=True, sliding_window=96), dict(sliding_window=40, logit_softcap=3.0)):
        got = cache_attention(q, k, v, 2, 192, **kw)
        want = cache_attention_plain(q, k, v, torch.tensor([2], dtype=torch.int32), 192, sm_scale=32 ** -0.5, **kw)
        assert torch.equal(got, want)


def test_cache_attention_refusals():
    k = torch.zeros((2, 2, 256, 32))
    q = torch.zeros((1, 4, 64, 32))
    with pytest.raises(ValueError, match="kv_end"):
        cache_attention(q, k, k, 0, 32)
    with pytest.raises(ValueError, match="exceeds"):
        cache_attention(q, k, k, 0, 300)
    with pytest.raises(ValueError, match="sinks need the ring"):
        cache_attention(q, k, k, 0, 128, sinks=4, sliding_window=96)
    with pytest.raises(ValueError, match="needs sliding_window"):
        cache_attention(q, k, k, 0, 128, ring=True)
    with pytest.raises(ValueError, match="must hold"):
        cache_attention(q, k, k, 0, 128, ring=True, sliding_window=200)
    with pytest.raises(ValueError, match="both k_scales"):
        cache_attention(q, k, k, 0, 128, k_scales=torch.ones((2, 2, 256, 1)))


# ---------------------------------------------------------------- the kernel's ring walk


@pytest.mark.parametrize("rows,sinks", [(256, 0), (384, 4), (384, 32), (4352, 0), (4480, 4)])
@pytest.mark.parametrize("q_tile", [64, 128])
def test_ring_walk_reads_each_visible_position_once_from_its_row(rows, sinks, q_tile):
    """K1r's walk over positions (``fwd_walk(ring=True)``): every column a
    block's rows see lies in exactly one walked tile, and each position a
    tile shows sits at the ring row of the tile's first position (``ring_rows``) plus its
    offset, the row the cache wrote it to: no tile straddles the ring's end.
    A sink tile shows only the sinks."""
    window = 96 if rows < 1000 else 4096
    t = 64 if rows < 1000 else 256
    for kv_end in sorted({t, window, rows - 64, rows, rows + 64, 2 * rows + 40, 3 * rows + 8}):
        if kv_end < t:
            continue
        for m0 in range(0, t, q_tile):
            walk = fwd_walk(m0, q_tile, t, kv_end, window=window, sinks=sinks, ring=True)
            diag = kv_end - t
            need = set()
            for i in range(m0, min(m0 + q_tile, t)):
                pos = i + diag
                need |= {c for c in range(max(0, pos - window + 1), pos + 1)} | set(range(min(sinks, pos + 1)))
            shown = {}
            for n0 in walk:
                lim = sinks if n0 < sinks else kv_end
                for c in range(n0, min(n0 + KV_TILE, lim)):
                    assert c not in shown, (kv_end, m0, c)
                    shown[c] = int(ring_rows(torch.tensor([n0]), rows, sinks)) + (c - n0)
            assert need <= shown.keys(), (kv_end, m0, sorted(need - shown.keys())[:5])
            cols = torch.tensor(sorted(need))
            assert torch.equal(torch.tensor([shown[c] for c in sorted(need)]), ring_rows(cols, rows, sinks))
            assert all(shown[c] < rows for c in need)


# ---------------------------------------------------------------- the output projection


def test_bf16_output_projection_is_jaxs_fp32_summed_einsum():
    """bf16 o through ``_output_proj``, one product over wo's [H * D, M]
    view with an fp32 result rounded once: JAX's einsum with
    preferred_element_type=float32, to within one bf16 rounding."""
    rng = np.random.default_rng(0)
    o = rng.normal(size=(1, 4, 64, 32)).astype(np.float32)
    wo = (rng.normal(size=(4, 32, 64)) / 12).astype(np.float32)
    o_b, wo_b = jnp.asarray(o, jnp.bfloat16), jnp.asarray(wo, jnp.bfloat16)
    want = np.asarray(jattn._output_proj({"wo": wo_b}, o_b, jnp.bfloat16).astype(jnp.float32))
    got = tattn._output_proj({"wo": torch.from_numpy(np.array(wo_b.astype(jnp.float32))).bfloat16()},
                             torch.from_numpy(np.array(o_b.astype(jnp.float32))).bfloat16(), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 64)
    assert np.all(np.abs(got.float().numpy() - want) <= 2.0 ** -8 * np.abs(want) + 1e-30)


def test_fp32_output_projection_keeps_the_einsum():
    """fp32 o keeps einsum's (d, h) sum, bit for bit."""
    gen = torch.Generator().manual_seed(1)
    o = torch.randn((2, 4, 48, 32), generator=gen)
    wo = torch.randn((4, 32, 64), generator=gen) / 12
    got = tattn._output_proj({"wo": wo}, o, torch.float32)
    assert torch.equal(got, torch.einsum("bhtd,hdm->btm", o, wo))


def test_output_projection_under_grad_keeps_the_einsum():
    """A bf16 product that keeps a gradient (training) stays the einsum,
    whose backward autograd has: o's and wo's gradients equal the einsum's."""
    gen = torch.Generator().manual_seed(2)
    o = torch.randn((1, 4, 32, 32), generator=gen).bfloat16().requires_grad_()
    wo = (torch.randn((4, 32, 64), generator=gen) / 12).bfloat16().requires_grad_()
    got = tattn._output_proj({"wo": wo}, o, torch.bfloat16)
    want = torch.einsum("bhtd,hdm->btm", o, wo)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen).bfloat16()
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(got, (o, wo), g),
                                                 torch.autograd.grad(want, (o, wo), g)))
