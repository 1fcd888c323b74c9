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
paged decode rows as it writes them, and the dense chunk prefill
dequantizes the visible slice in plain PyTorch before K1, as the JAX
package does in XLA. Projection weights may be int8 (``weight_quant``,
``w8_dequant``). The mask options the port does not implement raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from flash_attention_tpu_torch.models.rope import apply_rope
from flash_attention_tpu_torch.ops.common import LOG2E
from flash_attention_tpu_torch.ops.decode import decode_attention
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.ops.merge import merge_two
from flash_attention_tpu_torch.ops.paged import (
    PagedKVCache,
    paged_decode_attention,
    paged_prefill_attention,
    paged_write_prefill,
    paged_write_tokens,
)
from flash_attention_tpu_torch.ops.quant import QuantizedTensor, bits, payload_dtype, quantize_values, w8_dequant

_MASK_ITEM = "ROADMAP.md queue 1 item 3 (window, softcap, rolling cache and sinks)"
_SEGMENT_ITEM = "ROADMAP.md queue 1 item 3 (segment ids)"


def require_supported(cfg) -> None:
    """Raise NotImplementedError for a feature this slice of the port lacks."""
    unsupported = [
        ("sliding_window", cfg.sliding_window is not None, _MASK_ITEM),
        ("logit_softcap", cfg.logit_softcap is not None, _MASK_ITEM),
        ("rolling", cfg.rolling, _MASK_ITEM),
        ("attention_sinks", cfg.attention_sinks != 0, _MASK_ITEM),
    ]
    for name, used, item in unsupported:
        if used:
            raise NotImplementedError(f"{name}={getattr(cfg, name)!r} is not ported yet: {item}")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    model_dim: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    kv_quant: str = "none"
    dtype: str = "bfloat16"
    sliding_window: int | None = None
    logit_softcap: float | None = None
    rolling: bool = False
    attention_sinks: int = 0

    def __post_init__(self):
        require_supported(self)

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


def init_kv_cache(cfg: AttentionConfig, batch: int, max_seq: int, *, device) -> KVCache:
    """A zeroed cache; with ``cfg.kv_quant`` a zeroed payload and scales of 1."""
    payload = payload_dtype(cfg.kv_quant)
    shape = (batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
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

    Decode writes (T == 1) at or past capacity are DROPPED and the length
    stays at max_seq: clamping the position would overwrite the last live
    row. Prefill writes (T > 1) clamp their start so the rows fit, as JAX's
    dynamic_update_slice does. Lengths clamp to max_seq either way.
    """
    kq, ks = _quantize_for_cache(cfg, k_new)
    vq, vs = _quantize_for_cache(cfg, v_new)
    writes = [(cache.k, kq), (cache.v, vq)]
    if cache.quantized():
        writes += [(cache.k_scales, ks), (cache.v_scales, vs)]
    t = k_new.shape[2]
    max_seq = cache.k.shape[2]
    batch_idx = torch.arange(k_new.shape[0], device=cache.k.device)
    if t == 1:
        keep = (start_positions < max_seq)[:, None, None]
        pos = start_positions.clamp(max=max_seq - 1)
        for buf, new in writes:
            # Rewrite the old row where the write is dropped: no host sync.
            new, buf = bits(new[:, :, 0].to(buf.dtype)), bits(buf)
            buf[batch_idx, :, pos] = torch.where(keep, new, buf[batch_idx, :, pos])
    else:
        start = start_positions.clamp(0, max_seq - t)
        pos = start[:, None] + torch.arange(t, device=cache.k.device)[None, :]  # [B, T]
        for buf, new in writes:
            bits(buf)[batch_idx[:, None], :, pos] = bits(new.transpose(1, 2).to(buf.dtype))
    return cache._replace(lengths=(start_positions + t).clamp(max=max_seq).to(torch.int32))


def _weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A matmul weight in ``dtype``; an int8 one widens through bf16 first
    (``w8_dequant``), as in the JAX package."""
    return w8_dequant(w).to(dtype)


def _project_qkv(params, cfg: AttentionConfig, x: torch.Tensor, positions):
    """q/k/v projection + RoPE shared by every attention entry point.

    x: [B, T, model_dim]; positions: integers broadcastable to [B, 1, T].
    Returns (q, k, v) as [B, H, T, D] in the config dtype, q and k rotated.
    """
    dt = cfg.torch_dtype
    q = torch.einsum("btm,mhd->bhtd", x, _weight(params["wq"], x.dtype)).to(dt)
    k = torch.einsum("btm,mhd->bhtd", x, _weight(params["wk"], x.dtype)).to(dt)
    v = torch.einsum("btm,mhd->bhtd", x, _weight(params["wv"], x.dtype)).to(dt)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _output_proj(params, o: torch.Tensor, out_dtype) -> torch.Tensor:
    """wo projection of [B, H, T, D] attention output -> [B, T, model_dim]."""
    return torch.einsum("bhtd,hdm->btm", o, _weight(params["wo"], o.dtype)).to(out_dtype)


def _output_proj_decode(params, o: torch.Tensor, out_dtype) -> torch.Tensor:
    """wo projection of single-token [B, H, D] output -> [B, 1, model_dim]."""
    return torch.einsum("bhd,hdm->bm", o, _weight(params["wo"], o.dtype))[:, None, :].to(out_dtype)


def attention_prefill(params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache):
    """Causal prefill over [B, T, model_dim]; fills the cache from position 0.

    Returns (output [B, T, model_dim], updated cache).
    """
    batch, t, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, torch.arange(t, device=x.device)[None, None, :])
    o = flash_attention(q, k, v, causal=True)
    out = _output_proj(params, o, x.dtype)
    cache = write_cache(cfg, cache, k, v, torch.zeros((batch,), dtype=torch.int32, device=x.device))
    return out, cache


def attention_forward(params, cfg: AttentionConfig, x: torch.Tensor, *, positions=None, segment_ids=None):
    """Training-mode causal self-attention over [B, T, model_dim] (no cache).

    positions: optional [B, T] integer RoPE positions, default arange(T).
    segment_ids: packed-sequence ids; not ported yet (NotImplementedError).

    Returns [B, T, model_dim]; differentiable end to end (the attention's
    gradient runs the backward kernels, ``ops/attention_bwd.py``).
    """
    if segment_ids is not None:
        raise NotImplementedError(f"segment_ids is not ported yet: {_SEGMENT_ITEM}")
    _, t, _ = x.shape
    pos = torch.arange(t, device=x.device)[None, None, :] if positions is None else positions[:, None, :]
    q, k, v = _project_qkv(params, cfg, x, pos)
    o = flash_attention(q, k, v, causal=True)
    return _output_proj(params, o, x.dtype)


def attention_prefill_chunk(
    params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache, slot: int, start: int, kv_end: int
):
    """Prefill ONE CHUNK of one sequence into its slot of a batched cache.

    The chunk's queries attend the slot's cache prefix plus the chunk itself
    (the kernel's kv_len > q_len diagonal offset); the caller schedules
    chunks so ``start + T == kv_end``.

    Args:
      x: [1, T, model_dim] — the chunk (right-padded on the LAST chunk only;
        padded rows write K/V past the true length, which no later chunk or
        decode step can see).
      cache: the batched [slots, ...] KVCache (K/V written in place).
      slot, start, kv_end: host integers — the batch row, the chunk's first
        position and the visible KV horizon.

    Returns:
      (output [1, T, model_dim], updated cache).
    """
    _, t, _ = x.shape
    if start + t > cache.k.shape[2]:
        raise ValueError(f"chunk rows [{start}, {start + t}) exceed the cache's {cache.k.shape[2]}")
    q, k, v = _project_qkv(params, cfg, x, start + torch.arange(t, device=x.device)[None, None, :])
    # Write the chunk's K/V FIRST so the visible slice [0, kv_end) holds it.
    kq, ks = _quantize_for_cache(cfg, k[0])
    vq, vs = _quantize_for_cache(cfg, v[0])
    bits(cache.k)[slot, :, start:start + t] = bits(kq.to(cache.k.dtype))
    bits(cache.v)[slot, :, start:start + t] = bits(vq.to(cache.v.dtype))
    if cache.quantized():
        cache.k_scales[slot, :, start:start + t] = ks
        cache.v_scales[slot, :, start:start + t] = vs
    lengths = cache.lengths.clone()
    lengths[slot] = start + t
    cache = cache._replace(lengths=lengths)

    def visible(buf, scales):
        # The visible prefix goes to the kernel as a strided view, not a
        # copy; a quantized one is dequantized here, in plain PyTorch, as
        # the JAX package does in XLA (models/attention.py:496-511).
        vis = buf[slot:slot + 1, :, :kv_end]
        if scales is None:
            return vis
        return (vis.float() * scales[slot:slot + 1, :, :kv_end]).to(cfg.torch_dtype)

    o = flash_attention(q, visible(cache.k, cache.k_scales), visible(cache.v, cache.v_scales), causal=True)
    return _output_proj(params, o, x.dtype), cache


def attention_decode(params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache):
    """One decode step over [B, 1, model_dim] against the cache.

    Returns (output [B, 1, model_dim], updated cache).
    """
    q, k, v = _project_qkv(params, cfg, x, cache.lengths[:, None, None])
    cache = write_cache(cfg, cache, k, v, cache.lengths)
    # A quantized cache goes to K6 as payload and scales: the kernel
    # dequantizes, and the current token is attended as stored, quantized.
    o = decode_attention(q[:, :, 0, :], cache.k_view(), cache.v_view(), cache.lengths)
    return _output_proj_decode(params, o, x.dtype), cache


def attention_prefill_paged(params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache, slot: int, true_len):
    """Causal prefill of ONE sequence ([1, T, model_dim], T a multiple of the
    page size) writing its K/V into ``slot``'s pages.

    Returns (output [1, T, model_dim], updated cache).
    """
    _, t, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, torch.arange(t, device=x.device)[None, None, :])
    o = flash_attention(q, k, v, causal=True)
    out = _output_proj(params, o, x.dtype)
    return out, paged_write_prefill(paged_cache, k[0], v[0], slot, true_len)


def attention_prefill_chunk_paged(
    params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache, slot: int, start: int, kv_end: int
):
    """Chunked prefill over a paged cache: one chunk ([1, T, model_dim], T a
    page multiple) of one sequence, attending the slot's rows [0, kv_end)
    (start + T == kv_end; host integers). Returns (output, updated cache)."""
    _, t, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, start + torch.arange(t, device=x.device)[None, None, :])
    paged_cache = paged_write_prefill(paged_cache, k[0], v[0], slot, start + t, start=start)
    # K8 reads the slot's pages in place, up to the chunk's diagonal.
    o = paged_prefill_attention(q, paged_cache, slot, kv_end, chunk_len=t)
    return _output_proj(params, o, x.dtype), paged_cache


def attention_decode_paged_deferred(params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache):
    """Decode-step attention WITHOUT the cache write.

    K7 attends over the cache as it is (the new token is not in it yet, so
    ``lengths`` excludes it and may be 0), and the token's self term, score
    q·k_new in fp32 and output v_new, is folded in with ``merge_two`` in the
    base-2 LSE domain. The self term is at full precision even over a
    quantized cache, where K10 stores the token quantized, as in the JAX
    package. The caller writes every layer's (k_new, v_new) in one
    ``paged_write_tokens_multi`` launch after the layer stack.

    Returns (output [num_slots, 1, model_dim], (k_new, v_new) each
    [num_slots, kv_heads, head_dim]).
    """
    q, k, v = _project_qkv(params, cfg, x, paged_cache.lengths[:, None, None])
    q1, k1, v1 = q[:, :, 0, :], k[:, :, 0, :], v[:, :, 0, :]
    o_c, lse_c = paged_decode_attention(q1, paged_cache, save_residuals=True)
    group = cfg.num_q_heads // cfg.num_kv_heads
    k_exp = k1.repeat_interleave(group, dim=1)  # [n, Hq, D]
    v_exp = v1.repeat_interleave(group, dim=1)
    s_raw = (q1.float() * k_exp.float()).sum(dim=-1)  # [n, Hq]
    lse_self = s_raw * (1.0 / math.sqrt(cfg.head_dim)) * LOG2E  # a single score's LSE is the score
    o, _ = merge_two(o_c, lse_c, v_exp, lse_self)
    return _output_proj_decode(params, o, x.dtype), (k1, v1)


def attention_decode_paged(params, cfg: AttentionConfig, x: torch.Tensor, paged_cache: PagedKVCache):
    """One write-first decode step over [num_slots, 1, model_dim]: every
    slot's new K/V row goes to its current length (K9), then K7 attends.

    Returns (output [num_slots, 1, model_dim], updated cache).
    """
    q, k, v = _project_qkv(params, cfg, x, paged_cache.lengths[:, None, None])
    slots = torch.arange(x.shape[0], device=x.device)
    paged_cache = paged_write_tokens(paged_cache, k[:, :, 0, :], v[:, :, 0, :], slots)
    o = paged_decode_attention(q[:, :, 0, :], paged_cache)
    return _output_proj_decode(params, o, x.dtype), paged_cache
