"""GQA attention layer with a decode KV cache, built on the port's kernels.

Counterpart of the JAX package's ``models/attention.py``. Training
(``attention_forward``, no cache) runs K1 forward and its backward kernels
through ``ops.flash_attention``'s autograd Function. Over the dense
cache, prefill runs through ``ops.flash_attention`` (K1, causal) and decode
through ``ops.decode.decode_attention`` (K6); over the paged cache
(``ops/paged.py``), chunked prefill through K8 and decode through K7 with
the deferred write (K10 after the layer stack). The functional surface is
kept (params dict and cache in, new cache out) so the tests compare like
with like, but the caches' K/V buffers are updated IN PLACE: a fresh
multi-GiB cache per step is what JAX's buffer donation avoids, and in-place
writes are how PyTorch avoids it. Lengths are replaced, not mutated, so a
caller holding an old cache tuple still sees its old lengths.

Caches are bf16/fp16/fp32 or quantized (``kv_quant``: int8, fp8_e4m3,
fp8_e5m2; ``ops/quant.py``): each row is stored as a payload with an fp32
scale, decode reads it through K6's and K7's dequant, K10 quantizes the
paged decode rows as it writes them, and a dense chunk prefill reads the
payload and scales in place through K1q (``ops.flash_attention.
cache_attention``), where the JAX package dequantizes the visible slice in
XLA first. Projection weights may be int8 (``weight_quant``):
with no gradient to keep, each product reads the int8 payload through
``ops.quant.w8_matmul`` (W1 / W2 on the card), q / k / v together through
``w8_matmul_group`` (one W1 launch at decode); under autograd the weight
widens through ``w8_dequant`` first.

Masks (the JAX package's ``models/attention.py``): a sliding window and a
logit softcap on every serving entry; the ROLLING cache (``rolling``): a
ring of ``rolling_buffer_len`` rows a slot holding position p at row p %
rows, with ``lengths`` counting every position written, never clamped to
the ring; and StreamingLLM attention SINKS in front of the ring (positions
[0, sinks) kept in their own 128-padded rows). Over the paged cache the
window makes the engine's paged ring (``serving/paged_engine.py``) and the
sinks pin logical page 0. The training entry ``attention_forward`` takes the
window and the softcap of its config and packed-sequence segment ids, under
grad as well (the backward kernels apply the forward's mask); the sinks are
a serving feature and are not applied there, as in the JAX package.

Tensor parallelism (``parallel/sharding.shard_model_params``): every
serving entry runs as it is on a rank's share of the heads, with the
config's head counts the rank's, and takes ``tp_group``, the process group
of the mesh's model axis. The output projection ``wo`` is row-parallel, so
each rank's product is a partial that ``row_parallel`` adds over the
group in fp32; everything before it, the deferred paged decode's self-term
merge included, is per head. With ``tp_group=None`` (the default) or a
group of one rank nothing is reduced and the path is the single-process
one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from flash_attention_tpu_torch.models.rope import apply_rope
from flash_attention_tpu_torch.ops.common import ceil_to, ring_layout, ring_rows, slot_index
from flash_attention_tpu_torch.ops.decode import decode_attention
from flash_attention_tpu_torch.ops.flash_attention import cache_attention, flash_attention
from flash_attention_tpu_torch.ops.fused import rope, rope_chunk, write_row_plain
from flash_attention_tpu_torch.ops.paged import (
    PagedKVCache,
    paged_decode_attention,
    paged_prefill_attention,
    paged_write_prefill,
    paged_write_tokens,
)
from flash_attention_tpu_torch.ops.quant import (
    QuantizedTensor,
    bits,
    payload_dtype,
    quantize_values,
    w8_dequant,
    w8_matmul,
    w8_matmul_group,
)
from flash_attention_tpu_torch.parallel.mesh import all_reduce_


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    model_dim: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    kv_quant: str = "none"
    dtype: str = "bfloat16"
    sliding_window: int | None = None  # Mistral-style local attention
    logit_softcap: float | None = None  # Gemma-2-style attention logit cap
    rolling: bool = False  # O(window) ring-buffer KV cache (needs sliding_window)
    attention_sinks: int = 0  # StreamingLLM sinks (dense: needs rolling)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class KVCache(NamedTuple):
    """Decode cache: [B, Hkv, max_seq, D] K and V (the model's dtype, or a
    quantized payload with fp32 scales [B, Hkv, max_seq, 1]) and [B] int32
    lengths."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    def quantized(self) -> bool:
        return self.k_scales is not None

    def k_view(self):
        return QuantizedTensor(self.k, self.k_scales) if self.quantized() else self.k

    def v_view(self):
        return QuantizedTensor(self.v, self.v_scales) if self.quantized() else self.v


def _normal(generator: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_attention_params(generator: torch.Generator, cfg: AttentionConfig) -> dict:
    """Random q/k/v/o projections on the generator's device, with the JAX
    package's shapes and scales (``wq/wk/wv`` [M, H, D], ``wo`` [Hq, D, M])."""
    dt = cfg.torch_dtype
    s = 1.0 / math.sqrt(cfg.model_dim)
    so = 1.0 / math.sqrt(cfg.num_q_heads * cfg.head_dim)
    return {
        "wq": _normal(generator, (cfg.model_dim, cfg.num_q_heads, cfg.head_dim), s, dt),
        "wk": _normal(generator, (cfg.model_dim, cfg.num_kv_heads, cfg.head_dim), s, dt),
        "wv": _normal(generator, (cfg.model_dim, cfg.num_kv_heads, cfg.head_dim), s, dt),
        "wo": _normal(generator, (cfg.num_q_heads, cfg.head_dim, cfg.model_dim), so, dt),
    }


def rolling_buffer_len(cfg: AttentionConfig, max_seq: int, prefill_chunk: int = 0) -> int:
    """Ring rows a slot: the window plus one prefill chunk of slack (a chunk
    of T rows overwrites rows T behind the write head, so the ring must hold
    window + T rows for the chunk's own lookback), 128-aligned, capped at
    the logical context; attention sinks add their own 128-padded rows in
    front of the ring."""
    ring = ceil_to(cfg.sliding_window + max(prefill_chunk, 1), 128)
    if cfg.attention_sinks:
        ring += ceil_to(cfg.attention_sinks, 128)
    return min(max_seq, ring)


def init_kv_cache(cfg: AttentionConfig, batch: int, max_seq: int, *, device, prefill_chunk: int = 0) -> KVCache:
    """A zeroed cache for ``max_seq`` positions a slot (a rolling cache holds
    ``rolling_buffer_len`` rows of them); with ``cfg.kv_quant`` a zeroed
    payload and scales of 1."""
    if cfg.rolling and cfg.sliding_window is None:
        raise ValueError("rolling cache requires sliding_window")
    if cfg.attention_sinks:
        if not cfg.rolling:
            raise ValueError("attention_sinks requires rolling=True")
        if cfg.attention_sinks + max(prefill_chunk, 1) > cfg.sliding_window:
            # The chunked-prefill sink merge needs every chunk past the
            # window to start at or after the sink rows.
            raise ValueError(
                f"attention_sinks ({cfg.attention_sinks}) + prefill chunk ({prefill_chunk}) must not exceed "
                f"sliding_window ({cfg.sliding_window})"
            )
    rows = rolling_buffer_len(cfg, max_seq, prefill_chunk) if cfg.rolling else max_seq
    payload = payload_dtype(cfg.kv_quant)
    shape = (batch, cfg.num_kv_heads, rows, cfg.head_dim)
    scales = [None, None]
    if payload is not None:
        scales = [torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device) for _ in range(2)]
    return KVCache(
        torch.zeros(shape, dtype=payload or cfg.torch_dtype, device=device),
        torch.zeros(shape, dtype=payload or cfg.torch_dtype, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
        *scales,
    )


def _quantize_for_cache(cfg: AttentionConfig, x: torch.Tensor):
    """Rows as the cache stores them: (payload, scales), or (x, None)."""
    payload = payload_dtype(cfg.kv_quant)
    if payload is None:
        return x.to(cfg.torch_dtype), None
    return quantize_values(x, payload)


def write_cache(cfg: AttentionConfig, cache: KVCache, k_new, v_new, start_positions) -> KVCache:
    """Insert [B, Hkv, T, D] new K/V rows at per-sequence start positions,
    quantized per row into a quantized cache (payload and scale).

    A rolling cache stores position p at its ring row (``ops.common.ring_rows``) and
    its lengths count every position written, never clamped to the ring; a
    write longer than the ring keeps only the rows the ring can hold (with
    sinks: the sink positions and the last ring-modulus rows). Otherwise,
    decode writes (T == 1) at or past capacity are DROPPED and the length
    stays at max_seq: clamping the position would overwrite the last live
    row. Prefill writes (T > 1) clamp their start so the rows fit, as JAX's
    dynamic_update_slice does. Lengths clamp to max_seq either way.
    """
    t = k_new.shape[2]
    if t == 1:
        return write_row_plain(cache, k_new, v_new, start_positions, ring=cfg.rolling, sinks=cfg.attention_sinks)
    kq, ks = _quantize_for_cache(cfg, k_new)
    vq, vs = _quantize_for_cache(cfg, v_new)
    writes = [(cache.k, kq), (cache.v, vq)]
    if cache.quantized():
        writes += [(cache.k_scales, ks), (cache.v_scales, vs)]
    max_seq = cache.k.shape[2]
    batch_idx = torch.arange(k_new.shape[0], device=cache.k.device)
    if cfg.rolling:
        p = start_positions.long()[:, None] + torch.arange(t, device=cache.k.device)[None, :]  # [B, T]
        if cfg.attention_sinks:
            keep = (p < cfg.attention_sinks) | (p >= p[:, -1:] + 1 - (max_seq - ceil_to(cfg.attention_sinks, 128)))
        else:
            keep = p >= p[:, -1:] + 1 - max_seq
        rows = ring_rows(p, max_seq, cfg.attention_sinks)
        b_idx, t_idx = keep.nonzero(as_tuple=True)
        for buf, new in writes:
            bits(buf)[b_idx, :, rows[b_idx, t_idx]] = bits(new[b_idx, :, t_idx].to(buf.dtype))
        return cache._replace(lengths=(start_positions + t).to(torch.int32))
    start = start_positions.clamp(0, max_seq - t)
    pos = start[:, None] + torch.arange(t, device=cache.k.device)[None, :]  # [B, T]
    for buf, new in writes:
        bits(buf)[batch_idx[:, None], :, pos] = bits(new.transpose(1, 2).to(buf.dtype))
    return cache._replace(lengths=(start_positions + t).clamp(max=max_seq).to(torch.int32))


def _weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A matmul weight in ``dtype``; an int8 one widens through bf16 first
    (``w8_dequant``), as in the JAX package."""
    return w8_dequant(w).to(dtype)


def int8_product(w, x: torch.Tensor) -> bool:
    """Whether x's product with ``w`` takes ``w8_matmul``: an int8 weight
    and no gradient to keep (the kernels have no backward; under autograd
    the weight widens through ``_weight``)."""
    return isinstance(w, QuantizedTensor) and not (torch.is_grad_enabled()
                                                   and (x.requires_grad or w.scales.requires_grad))


def _project(x: torch.Tensor, w, dt) -> torch.Tensor:
    """x [B, T, model_dim] @ w [model_dim, H, D] -> [B, H, T, D] in ``dt``."""
    if int8_product(w, x):
        return w8_matmul(x, w).permute(0, 2, 1, 3).to(dt)
    return torch.einsum("btm,mhd->bhtd", x, _weight(w, x.dtype)).to(dt)


def _qkv(params, cfg: AttentionConfig, x: torch.Tensor):
    """The q/k/v projections of x [B, T, model_dim]: [B, H, T, D] each in
    the config dtype, not rotated."""
    dt = cfg.torch_dtype
    ws = tuple(params[name] for name in ("wq", "wk", "wv"))
    if all(int8_product(w, x) for w in ws):
        return tuple(p.permute(0, 2, 1, 3).to(dt) for p in w8_matmul_group(x, ws))
    return tuple(_project(x, w, dt) for w in ws)


def _project_qkv(params, cfg: AttentionConfig, x: torch.Tensor, positions):
    """q/k/v projection + RoPE shared by every attention entry point.

    x: [B, T, model_dim]; positions: integers broadcastable to [B, 1, T].
    Returns (q, k, v) as [B, H, T, D] in the config dtype, q and k rotated:
    under autograd by ``apply_rope``, else in one launch of
    ``ops.fused.rope`` (F2 on the card).
    """
    q, k, v = _qkv(params, cfg, x)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return apply_rope(q, positions, theta=cfg.rope_theta), apply_rope(k, positions, theta=cfg.rope_theta), v
    q, k = rope(q, k, positions, theta=cfg.rope_theta)
    return q, k, v


def tensor_parallel(tp_group) -> bool:
    """Whether ``tp_group`` splits the model over more than one rank (with
    one rank a row-parallel partial is the whole product)."""
    return tp_group is not None and dist.get_world_size(tp_group) > 1


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] @ ``w`` [K, N] in fp32, never rounded to x's dtype
    (the JAX package's ``preferred_element_type=float32``): on the card
    cuBLAS's 16-bit GEMM with an fp32 output, elsewhere the exact products
    summed in fp32. No gradient (``torch.mm``'s fp32 output has none)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype in (torch.float16, torch.bfloat16):
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), w.float())
    return out.reshape(*x.shape[:-1], w.shape[-1])


def row_parallel(x: torch.Tensor, w, out_dtype, tp_group) -> torch.Tensor:
    """``x`` [..., K] @ ``w`` [K, M] over this rank's share of K, summed over
    ``tp_group`` in ``out_dtype``. The partial leaves the GEMM in fp32
    (``matmul_f32``, or ``w8_matmul``'s fp32 output for an int8 ``w``
    [K..., M]) and the all-reduce adds in fp32, so the sum is rounded once, as
    the single-process GEMM's fp32 accumulator is: only the order of the fp32
    additions differs."""
    if isinstance(w, QuantizedTensor):
        partial = w8_matmul(x, w, out_dtype=torch.float32)
    else:
        partial = matmul_f32(x, w)
    return all_reduce_(partial, dist.ReduceOp.SUM, tp_group).to(out_dtype)


def _output_proj(params, o: torch.Tensor, out_dtype, tp_group=None) -> torch.Tensor:
    """wo projection of [B, H, T, D] attention output -> [B, T, model_dim]."""
    b, h, t, d = o.shape
    if int8_product(params["wo"], o):
        o2 = o.transpose(1, 2).reshape(b, t, h * d)
        if not tensor_parallel(tp_group):
            return w8_matmul(o2, params["wo"]).to(out_dtype)
        return row_parallel(o2, params["wo"], out_dtype, tp_group)
    wo = _weight(params["wo"], o.dtype)
    grad = torch.is_grad_enabled() and (o.requires_grad or wo.requires_grad)
    if not tensor_parallel(tp_group) and (o.dtype == torch.float32 or grad):
        # fp32 keeps einsum, which sums over (d, h) and copies wo into that
        # order: over an int8 KV cache, the product over wo's [H * D, M] view
        # sums over (h, d), which flips cache codes enough to move the
        # unsharded fp32 logits 1e-4 (relative) from the tensor-parallel
        # model's, against 7e-7 with einsum (tests/test_torch_sharded_serving.py,
        # 1e-5 bar). A product that keeps a gradient keeps it too:
        # matmul_f32's fp32 output has none. bf16 / fp16 serving reads the
        # view, with no copy of wo.
        return torch.einsum("bhtd,hdm->btm", o, wo).to(out_dtype)
    o2, wo2 = o.transpose(1, 2).reshape(b, t, h * d), wo.reshape(h * d, -1)
    if tensor_parallel(tp_group):
        return row_parallel(o2, wo2, out_dtype, tp_group)
    # One GEMM over wo's [H * D, M] view with an fp32 result rounded once to
    # out_dtype, as the JAX package's preferred_element_type=float32 and
    # row_parallel's partial.
    return matmul_f32(o2, wo2).to(out_dtype)


def _output_proj_decode(params, o: torch.Tensor, out_dtype, tp_group=None) -> torch.Tensor:
    """wo projection of single-token [B, H, D] output -> [B, 1, model_dim]:
    one product over wo's [H * D, model_dim] view (``einsum`` permuted wo
    into a copy of the whole weight on every step)."""
    b, h, d = o.shape
    o2 = o.reshape(b, 1, h * d)
    if int8_product(params["wo"], o):
        if not tensor_parallel(tp_group):
            return w8_matmul(o2, params["wo"]).to(out_dtype)
        return row_parallel(o2, params["wo"], out_dtype, tp_group)
    wo2 = _weight(params["wo"], o.dtype).reshape(h * d, -1)
    if not tensor_parallel(tp_group):
        return torch.matmul(o2, wo2).to(out_dtype)
    return row_parallel(o2, wo2, out_dtype, tp_group)


def _masks(cfg: AttentionConfig) -> dict:
    return dict(sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap)


def attention_prefill(params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache, *, tp_group=None):
    """Causal prefill over [B, T, model_dim]; fills the cache from position 0.

    Returns (output [B, T, model_dim], updated cache).
    """
    batch, t, _ = x.shape
    if cfg.attention_sinks and t > cfg.sliding_window:
        raise ValueError(
            "attention_sinks prompts longer than the window must prefill in chunks (attention_prefill_chunk "
            "applies the sinks and window mask; the one-shot path would mask the sinks out)"
        )
    q, k, v = _project_qkv(params, cfg, x, torch.arange(t, device=x.device)[None, None, :])
    o = flash_attention(q, k, v, causal=True, **_masks(cfg))
    out = _output_proj(params, o, x.dtype, tp_group)
    cache = write_cache(cfg, cache, k, v, torch.zeros((batch,), dtype=torch.int32, device=x.device))
    return out, cache


def attention_forward(params, cfg: AttentionConfig, x: torch.Tensor, *, positions=None, segment_ids=None):
    """Training-mode causal self-attention over [B, T, model_dim] (no cache).

    positions: optional [B, T] integer RoPE positions (packed sequences
      restart them per document), default arange(T).
    segment_ids: optional [B, T] integer packed-sequence ids, masked in the
      kernels (K1d forward) beside ``cfg``'s window and softcap.

    Returns [B, T, model_dim]; differentiable end to end (the attention's
    gradient runs the backward kernels, ``ops/attention_bwd.py``).
    """
    _, t, _ = x.shape
    pos = torch.arange(t, device=x.device)[None, None, :] if positions is None else positions[:, None, :]
    q, k, v = _project_qkv(params, cfg, x, pos)
    o = flash_attention(q, k, v, causal=True, segment_ids=segment_ids, **_masks(cfg))
    return _output_proj(params, o, x.dtype)


def attention_prefill_chunk(
    params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache, slot, start: int, kv_end: int, *,
    tp_group=None,
):
    """Prefill ONE CHUNK of one sequence into its slot of a batched cache.

    The chunk's queries attend the slot's cache prefix plus the chunk itself
    (the kernel's kv_len > q_len diagonal offset); the caller schedules
    chunks so ``start + T == kv_end``.

    The chunk's RoPE and its cache write (K / V rows, a quantized cache's
    scales, the slot's length) are one launch on the card (F2c,
    ``ops.fused.rope_chunk``), as XLA fuses them in the JAX package's jitted
    chunk step. Over a rolling cache the chunk's rows go to their ring rows
    (a chunk may wrap the ring's end) and the chunk attends the last min(kv_end, window +
    T) positions and, with sinks, the sink positions. The attention reads
    the slot of the cache where it lies (``ops.flash_attention.
    cache_attention``: K1, K1q over a quantized cache, K1r over the ring);
    the JAX package's gather of the ring in position order, dequant and,
    with sinks past the window, two passes merged by LSE are its plain
    version, which the CPU runs.

    Args:
      x: [1, T, model_dim] — the chunk (right-padded on the LAST chunk only;
        padded rows write K/V past the true length, which no later chunk or
        decode step can see).
      cache: the batched [slots, ...] KVCache (K/V written in place).
      slot: the batch row: a host int, or a one-element tensor on the
        device (JAX's traced slot; the serving engines' prefill programs
        keep theirs in one, filled between replays of a CUDA graph). Every
        read and write of the slot's rows indexes with it on the device
        (``ops.common.slot_index``), and the kernels read it from device
        memory over the whole cache.
      start, kv_end: host integers — the chunk's first position and the
        visible KV horizon.

    Returns:
      (output [1, T, model_dim], updated cache).
    """
    _, t, _ = x.shape
    rows = cache.k.shape[2]
    sinks = cfg.attention_sinks
    if cfg.rolling:
        ring_mod, _ = ring_layout(rows, sinks)
        if ring_mod < cfg.sliding_window + t:
            raise ValueError(
                f"rolling ring ({ring_mod} of buffer {rows}) must hold window ({cfg.sliding_window}) + chunk ({t}) "
                "rows: init the cache with prefill_chunk set"
            )
    elif start + t > rows:
        raise ValueError(f"chunk rows [{start}, {start + t}) exceed the cache's {rows}")
    slot = slot_index(slot, cache.k.shape[0], x.device)
    q, k, v = _qkv(params, cfg, x)
    # RoPE, then the chunk's K/V written FIRST so the visible rows hold it,
    # and the slot's length: one launch (F2c on the card).
    q, cache = rope_chunk(q, k, v, cache, slot, start, theta=cfg.rope_theta, ring=cfg.rolling, sinks=sinks)
    o = cache_attention(q, cache.k, cache.v, slot, kv_end, k_scales=cache.k_scales, v_scales=cache.v_scales,
                        ring=cfg.rolling, sinks=sinks, **_masks(cfg))
    return _output_proj(params, o, x.dtype, tp_group), cache


def attention_decode(params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache, *, tp_group=None):
    """One decode step over [B, 1, model_dim] against the cache (a rolling
    one masked by the positions its rows hold).

    Returns (output [B, 1, model_dim], updated cache).
    """
    q, k, v = _qkv(params, cfg, x)
    # RoPE and the row write in one launch (F2 on the card), by write_cache's rules.
    q, _, cache = rope(q, k, cache.lengths[:, None, None], theta=cfg.rope_theta, cache=cache, v=v, ring=cfg.rolling,
                       sinks=cfg.attention_sinks)
    # A quantized cache goes to K6 as payload and scales: the kernel
    # dequantizes, and the current token is attended as stored, quantized.
    o = decode_attention(
        q[:, :, 0, :], cache.k_view(), cache.v_view(), cache.lengths, ring_buffer=cfg.rolling,
        attention_sinks=cfg.attention_sinks, **_masks(cfg),
    )
    return _output_proj_decode(params, o, x.dtype, tp_group), cache


def attention_prefill_paged(params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache, slot: int, true_len,
                            *, tp_group=None):
    """Causal prefill of ONE sequence ([1, T, model_dim], T a multiple of the
    page size) writing its K/V into ``slot``'s pages.

    Returns (output [1, T, model_dim], updated cache).
    """
    _, t, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, torch.arange(t, device=x.device)[None, None, :])
    o = flash_attention(q, k, v, causal=True, **_masks(cfg))
    out = _output_proj(params, o, x.dtype, tp_group)
    return out, paged_write_prefill(paged_cache, k[0], v[0], slot, true_len)


def attention_prefill_chunk_paged(
    params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache, slot, start: int, kv_end: int, *,
    tp_group=None,
):
    """Chunked prefill over a paged cache: one chunk ([1, T, model_dim], T a
    page multiple) of one sequence, attending the slot's rows [0, kv_end)
    (start + T == kv_end; host integers). ``slot``: a host int or a
    one-element device tensor, as in ``attention_prefill_chunk``: the page
    write and K8 find the slot's table row on the device. Returns (output,
    updated cache)."""
    _, t, _ = x.shape
    slot = slot_index(slot, paged_cache.page_table.shape[0], x.device)
    q, k, v = _qkv(params, cfg, x)
    # RoPE and the page write, lengths[slot] = start + t: one launch (F2c on the card).
    q, paged_cache = rope_chunk(q, k, v, paged_cache, slot, start, theta=cfg.rope_theta)
    # K8 reads the slot's pages in place, from the window's first page (and
    # the sinks' page 0) up to the chunk's diagonal: over the paged ring the
    # pages below the band alias newer ones and are never read.
    o = paged_prefill_attention(q, paged_cache, slot, kv_end, chunk_len=t, attention_sinks=cfg.attention_sinks,
                                **_masks(cfg))
    return _output_proj(params, o, x.dtype, tp_group), paged_cache


def attention_decode_paged_deferred(params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache, *,
                                    tp_group=None):
    """Decode-step attention WITHOUT the cache write.

    K7 attends over the cache as it is (the new token is not in it yet, so
    ``lengths`` excludes it and may be 0), and the token's self term, score
    q·k_new in fp32 (through the softcap) and output v_new, is merged in
    the same launch (``paged_decode_attention(self_kv=...)``; on the CPU
    ``merge_self_plain``, ``merge_two`` in the base-2 LSE domain). The
    window goes down by one, since ``lengths`` does not count the current
    token. The self term is at full precision even over a quantized cache,
    where K10 stores the token quantized, as in the JAX package. The caller
    writes every layer's (k_new, v_new) in one ``paged_write_tokens_multi``
    launch after the layer stack.

    Returns (output [num_slots, 1, model_dim], (k_new, v_new) each
    [num_slots, kv_heads, head_dim]).
    """
    window = cfg.sliding_window
    if window is not None:
        if window <= 1:
            raise ValueError("deferred decode requires sliding_window > 1; use attention_decode_paged")
        window -= 1
    q, k, v = _project_qkv(params, cfg, x, paged_cache.lengths[:, None, None])
    q1, k1, v1 = q[:, :, 0, :], k[:, :, 0, :], v[:, :, 0, :]
    o = paged_decode_attention(q1, paged_cache, sliding_window=window, logit_softcap=cfg.logit_softcap,
                               attention_sinks=cfg.attention_sinks, self_kv=(k1, v1))
    return _output_proj_decode(params, o, x.dtype, tp_group), (k1, v1)


def attention_decode_paged(params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache, *, tp_group=None):
    """One write-first decode step over [num_slots, 1, model_dim]: every
    slot's new K/V row goes to its current length (K9), then K7 attends.

    Returns (output [num_slots, 1, model_dim], updated cache).
    """
    q, k, v = _project_qkv(params, cfg, x, paged_cache.lengths[:, None, None])
    slots = torch.arange(x.shape[0], device=x.device)
    paged_cache = paged_write_tokens(paged_cache, k[:, :, 0, :], v[:, :, 0, :], slots)
    o = paged_decode_attention(q[:, :, 0, :], paged_cache, attention_sinks=cfg.attention_sinks, **_masks(cfg))
    return _output_proj_decode(params, o, x.dtype, tp_group), paged_cache
