"""GQA attention layer with a decode KV cache, built on the port's kernels.

Counterpart of ``flash_attention_tpu/models/attention.py``. Over the dense
cache, prefill runs through ``ops.flash_attention`` (K1, causal) and decode
through ``ops.decode.decode_attention`` (K6); over the paged cache
(``ops/paged.py``), chunked prefill through K8 and decode through K7 with
the deferred write (K10 after the layer stack). The functional surface is
kept (params dict and cache in, new cache out) so the tests compare like
with like, but the caches' K/V buffers are updated IN PLACE: a fresh
multi-GiB cache per step is what JAX's buffer donation avoids, and in-place
writes are how PyTorch avoids it. Lengths are replaced, not mutated, so a
caller holding an old cache tuple still sees its old lengths.

The port covers bf16/fp16/fp32 caches; the configurations it does not
implement raise NotImplementedError naming their ROADMAP.md item.
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

_QUANT_ITEM = "ROADMAP.md queue 1 item 2 (KV and weight quantization)"
_MASK_ITEM = "ROADMAP.md queue 1 item 3 (window, softcap, rolling cache and sinks)"


def require_supported(cfg) -> None:
    """Raise NotImplementedError for a feature this slice of the port lacks."""
    unsupported = [
        ("kv_quant", cfg.kv_quant != "none", _QUANT_ITEM),
        ("weight_quant", getattr(cfg, "weight_quant", "none") != "none", _QUANT_ITEM),
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
    """Decode cache: [B, Hkv, max_seq, D] K and V, and [B] int32 lengths."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


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
    shape = (batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def write_cache(cfg: AttentionConfig, cache: KVCache, k_new, v_new, start_positions) -> KVCache:
    """Insert [B, Hkv, T, D] new K/V rows at per-sequence start positions.

    Decode writes (T == 1) at or past capacity are DROPPED and the length
    stays at max_seq: clamping the position would overwrite the last live
    row. Prefill writes (T > 1) clamp their start so the rows fit, as JAX's
    dynamic_update_slice does. Lengths clamp to max_seq either way.
    """
    t = k_new.shape[2]
    max_seq = cache.k.shape[2]
    batch_idx = torch.arange(k_new.shape[0], device=cache.k.device)
    if t == 1:
        keep = (start_positions < max_seq)[:, None, None]
        pos = start_positions.clamp(max=max_seq - 1)
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            # Rewrite the old row where the write is dropped: no host sync.
            buf[batch_idx, :, pos] = torch.where(keep, new[:, :, 0].to(buf.dtype), buf[batch_idx, :, pos])
    else:
        start = start_positions.clamp(0, max_seq - t)
        pos = start[:, None] + torch.arange(t, device=cache.k.device)[None, :]  # [B, T]
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            buf[batch_idx[:, None], :, pos] = new.transpose(1, 2).to(buf.dtype)
    return cache._replace(lengths=(start_positions + t).clamp(max=max_seq).to(torch.int32))


def _project_qkv(params, cfg: AttentionConfig, x: torch.Tensor, positions):
    """q/k/v projection + RoPE shared by every attention entry point.

    x: [B, T, model_dim]; positions: integers broadcastable to [B, 1, T].
    Returns (q, k, v) as [B, H, T, D] in the config dtype, q and k rotated.
    """
    dt = cfg.torch_dtype
    q = torch.einsum("btm,mhd->bhtd", x, params["wq"]).to(dt)
    k = torch.einsum("btm,mhd->bhtd", x, params["wk"]).to(dt)
    v = torch.einsum("btm,mhd->bhtd", x, params["wv"]).to(dt)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _output_proj(params, o: torch.Tensor, out_dtype) -> torch.Tensor:
    """wo projection of [B, H, T, D] attention output -> [B, T, model_dim]."""
    return torch.einsum("bhtd,hdm->btm", o, params["wo"]).to(out_dtype)


def _output_proj_decode(params, o: torch.Tensor, out_dtype) -> torch.Tensor:
    """wo projection of single-token [B, H, D] output -> [B, 1, model_dim]."""
    return torch.einsum("bhd,hdm->bm", o, params["wo"])[:, None, :].to(out_dtype)


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
    cache.k[slot, :, start:start + t] = k[0].to(cache.k.dtype)
    cache.v[slot, :, start:start + t] = v[0].to(cache.v.dtype)
    lengths = cache.lengths.clone()
    lengths[slot] = start + t
    cache = cache._replace(lengths=lengths)
    # The visible prefix goes to the kernel as a strided view, not a copy.
    o = flash_attention(q, cache.k[slot:slot + 1, :, :kv_end], cache.v[slot:slot + 1, :, :kv_end], causal=True)
    return _output_proj(params, o, x.dtype), cache


def attention_decode(params, cfg: AttentionConfig, x: torch.Tensor, cache: KVCache):
    """One decode step over [B, 1, model_dim] against the cache.

    Returns (output [B, 1, model_dim], updated cache).
    """
    q, k, v = _project_qkv(params, cfg, x, cache.lengths[:, None, None])
    cache = write_cache(cfg, cache, k, v, cache.lengths)
    o = decode_attention(q[:, :, 0, :], cache.k, cache.v, cache.lengths)
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
    base-2 LSE domain. The caller writes every layer's (k_new, v_new) in one
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
