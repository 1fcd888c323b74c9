"""LLaMA-class decoder-only transformer built on the port's attention layer.

Counterpart of the JAX package's ``models/transformer.py``: the training
forward ``train_forward`` (no caches; differentiate it with autograd), and
the serving paths ``prefill``, ``prefill_chunk``, ``decode_step_logits`` and
``decode_step`` over dense caches, and their ``*_paged`` twins over the
paged model cache (``ops/paged.PagedModelCache``), with a params dict of
the JAX package's tree and shapes (``models/convert.py`` maps one onto the
other). The embedding is tied. With ``weight_quant="int8"`` the matmul
weights and the embedding are stored int8 with one fp32 scale per output
channel (per vocabulary row for the embedding), W8A16: each matmul widens
its weight through bf16 first (``ops/quant.w8_dequant``), as the JAX package
does; the JAX package has no kernel for it (XLA fuses the widen into the
matmul), so the port's is plain PyTorch.

Matmuls stay ``torch.matmul`` / ``einsum``, as the JAX package left them to
XLA. One numerical difference: where JAX asks XLA for fp32 products of bf16
operands (``preferred_element_type``), a bf16 ``torch.matmul`` rounds its
output to bf16. fp32 configurations are unaffected.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.models.attention import (
    AttentionConfig,
    _normal,
    _weight,
    attention_decode,
    attention_decode_paged_deferred,
    attention_forward,
    attention_prefill,
    attention_prefill_chunk,
    attention_prefill_chunk_paged,
    attention_prefill_paged,
    init_attention_params,
    init_kv_cache,
    require_supported,
)
from flash_attention_tpu_torch.ops.paged import PagedModelCache, init_paged_model_cache, paged_write_tokens_multi
from flash_attention_tpu_torch.ops.quant import QuantizedTensor, quantize_weight


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    model_dim: int = 4096
    num_layers: int = 32
    num_q_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    kv_quant: str = "none"
    weight_quant: str = "none"
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

    def attention_config(self) -> AttentionConfig:
        return AttentionConfig(
            model_dim=self.model_dim,
            num_q_heads=self.num_q_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            kv_quant=self.kv_quant,
            dtype=self.dtype,
            sliding_window=self.sliding_window,
            logit_softcap=self.logit_softcap,
            rolling=self.rolling,
            attention_sinks=self.attention_sinks,
        )


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def swiglu(x: torch.Tensor, params) -> torch.Tensor:
    gate = torch.matmul(x, _weight(params["w_gate"], x.dtype)).float()
    up = torch.matmul(x, _weight(params["w_up"], x.dtype)).float()
    act = (F.silu(gate) * up).to(x.dtype)
    return torch.matmul(act, _weight(params["w_down"], x.dtype)).to(x.dtype)


def init_model_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device, drawn from it, with the
    JAX package's tree, shapes and scales (the draws themselves differ);
    quantized by ``quantize_model_weights`` when ``cfg.weight_quant`` is
    "int8"."""
    dt = cfg.torch_dtype
    device = generator.device
    acfg = cfg.attention_config()
    s_in = 1.0 / math.sqrt(cfg.model_dim)
    s_mlp = 1.0 / math.sqrt(cfg.mlp_dim)

    def init_layer():
        return {
            "attn": init_attention_params(generator, acfg),
            "attn_norm": torch.ones((cfg.model_dim,), dtype=dt, device=device),
            "mlp_norm": torch.ones((cfg.model_dim,), dtype=dt, device=device),
            "mlp": {
                "w_gate": _normal(generator, (cfg.model_dim, cfg.mlp_dim), s_in, dt),
                "w_up": _normal(generator, (cfg.model_dim, cfg.mlp_dim), s_in, dt),
                "w_down": _normal(generator, (cfg.mlp_dim, cfg.model_dim), s_mlp, dt),
            },
        }

    if cfg.weight_quant not in ("none", "int8"):
        raise ValueError(f"unknown weight_quant {cfg.weight_quant!r}")
    params = {
        "embed": _normal(generator, (cfg.vocab_size, cfg.model_dim), s_in, dt),
        "layers": [init_layer() for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.model_dim,), dtype=dt, device=device),
    }
    return quantize_model_weights(params) if cfg.weight_quant == "int8" else params


def quantize_model_weights(params: dict) -> dict:
    """Weight-only int8 (W8A16) copy of a parameter tree: every matmul
    weight becomes a QuantizedTensor with one fp32 scale per output channel
    (the absmax over the dims the matmul contracts); norms stay as they are.
    The embedding quantizes per vocabulary row, so one payload serves the
    lookup and the tied unembed."""

    def q_layer(lp):
        attn = dict(lp["attn"])
        for name, dims in (("wq", 0), ("wk", 0), ("wv", 0), ("wo", (0, 1))):
            attn[name] = quantize_weight(attn[name], contract_dims=dims)
        mlp = {name: quantize_weight(w, contract_dims=0) for name, w in lp["mlp"].items()}
        return {**lp, "attn": attn, "mlp": mlp}

    return {
        **params,
        "embed": quantize_weight(params["embed"], contract_dims=1),
        "layers": [q_layer(lp) for lp in params["layers"]],
    }


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> list:
    acfg = cfg.attention_config()
    return [init_kv_cache(acfg, batch, max_seq, device=device) for _ in range(cfg.num_layers)]


def _trunk(params, cfg: ModelConfig, tokens: torch.Tensor, attn_fn, caches=None):
    """Shared decoder trunk: embed -> N x (pre-norm attention via ``attn_fn``
    + pre-norm SwiGLU, both residual) -> final norm -> tied-embedding logits.

    ``attn_fn(layer_attn_params, acfg, h, cache) -> (attn_out, new_cache)``
    is the one piece the entry points differ in (cache is None throughout
    on the cache-free training path, ``caches=None``). Returns (logits
    [B, T, vocab] fp32, new caches).
    """
    acfg = cfg.attention_config()
    emb = params["embed"]
    dt = cfg.torch_dtype
    if isinstance(emb, QuantizedTensor):
        # Per-vocab-row scales serve both directions: a looked-up row widens
        # with its own scale; the unembed contracts over model_dim and the
        # scale lands on the output's vocab axis, in fp32.
        x = emb.values[tokens].to(dt) * emb.scales[tokens].to(dt)
    else:
        x = emb[tokens].to(dt)
    new_caches = []
    if caches is None:
        caches = [None] * len(params["layers"])
    for lp, cache in zip(params["layers"], caches):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        attn_out, cache = attn_fn(lp["attn"], acfg, h, cache)
        x = x + attn_out
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(h, lp["mlp"])
        new_caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if isinstance(emb, QuantizedTensor):
        logits = torch.matmul(x, emb.values.to(dt).t()).float() * emb.scales[:, 0].float()
    else:
        logits = torch.matmul(x, emb.t()).float()
    return logits, new_caches


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, *, decode: bool = False):
    """Run the model over [B, T] tokens (T=1 when decode=True).

    Returns (logits [B, T, vocab], updated caches).
    """
    attn = attention_decode if decode else attention_prefill
    return _trunk(params, cfg, tokens, attn, caches)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list):
    return forward(params, cfg, tokens, caches, decode=False)


def train_forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, segment_ids=None) -> torch.Tensor:
    """Training-mode forward (no KV caches): causal LM logits [B, T, vocab]
    fp32 over [B, T] tokens; differentiate a loss of them with autograd.
    ``segment_ids`` (packed batches) is not ported yet and raises
    NotImplementedError, as ``attention_forward`` does."""

    def attn(p, acfg, h, cache):
        return attention_forward(p, acfg, h, segment_ids=segment_ids), cache

    logits, _ = _trunk(params, cfg, tokens, attn)
    return logits


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, slot: int, start: int, kv_end: int):
    """Prefill ONE CHUNK ([1, T] tokens at positions [start, start+T)) of one
    sequence into its slot of the batched caches (start + T == kv_end).
    Returns (logits [1, T, vocab], updated caches)."""
    return _trunk(
        params, cfg, tokens,
        lambda p, acfg, h, c: attention_prefill_chunk(p, acfg, h, c, slot, start, kv_end),
        caches,
    )


def decode_step_logits(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list):
    """One decode step returning raw last-position logits [B, vocab] (the
    sampling layer chooses the token; see serving/sampling.py)."""
    logits, caches = forward(params, cfg, tokens, caches, decode=True)
    return logits[:, -1, :], caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list):
    """One greedy decode step: tokens [B, 1] -> (next_tokens [B, 1], caches)."""
    logits, caches = forward(params, cfg, tokens, caches, decode=True)
    return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32), caches


def init_paged_caches(
    cfg: ModelConfig, *, num_pages: int, num_slots: int, pages_per_slot: int, page_size: int = 128, device="cuda"
) -> PagedModelCache:
    """The model's zeroed PagedModelCache on ``device`` (the card by
    default): one [num_layers, num_pages, ...] pool per K and V, one page
    table and one lengths tensor, so K10 writes every layer in one launch.
    (The JAX package returns one PagedKVCache per layer; ``.layers()``
    gives those views.)"""
    return init_paged_model_cache(
        cfg.num_layers, num_pages=num_pages, num_slots=num_slots, pages_per_slot=pages_per_slot,
        kv_heads=cfg.num_kv_heads, page_size=page_size, head_dim=cfg.head_dim, dtype=cfg.torch_dtype,
        kv_quant=cfg.kv_quant, device=device,
    )


def _trunk_paged(params, cfg: ModelConfig, tokens: torch.Tensor, attn_fn, cache: PagedModelCache):
    """``_trunk`` over the model cache's layer views. Every layer's write
    sets the same lengths, so the last layer's are the model's."""
    logits, layers = _trunk(params, cfg, tokens, attn_fn, cache.layers())
    return logits, cache._replace(lengths=layers[-1].lengths)


def prefill_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache, slot: int, true_len):
    """Prefill ONE sequence ([1, T] tokens, T a page multiple) into its slot's
    pages. Returns (logits [1, T, vocab], updated cache)."""
    return _trunk_paged(
        params, cfg, tokens, lambda p, acfg, h, c: attention_prefill_paged(p, acfg, h, c, slot, true_len), cache
    )


def prefill_chunk_paged(
    params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache, slot: int, start: int, kv_end: int
):
    """Chunked prefill over the paged cache: [1, T] tokens at positions
    [start, start+T), T a page multiple, start + T == kv_end (host ints).
    Returns (logits [1, T, vocab], updated cache)."""
    return _trunk_paged(
        params, cfg, tokens,
        lambda p, acfg, h, c: attention_prefill_chunk_paged(p, acfg, h, c, slot, start, kv_end),
        cache,
    )


def decode_step_logits_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache):
    """One paged decode step returning raw last-position logits [S, vocab].

    The deferred-write path: every layer attends over the cache as it is,
    with the current token's self term merged in
    (``attention_decode_paged_deferred``, K7), and ALL layers' K/V rows land
    in one ``paged_write_tokens_multi`` launch (K10) after the layer stack.
    (The JAX package keeps a write-first path for sliding_window <= 1; the
    port has no sliding window yet, so it has no such branch.)
    """
    k_rows, v_rows = [], []

    def attn(lp, acfg, h, layer):
        out, (k, v) = attention_decode_paged_deferred(lp, acfg, h, layer)
        k_rows.append(k)
        v_rows.append(v)
        return out, layer

    logits, _ = _trunk(params, cfg, tokens, attn, cache.layers())
    slots = torch.arange(tokens.shape[0], device=tokens.device)
    cache = paged_write_tokens_multi(cache, torch.stack(k_rows), torch.stack(v_rows), slots)
    return logits[:, -1, :], cache


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache):
    """One greedy decode step over all slots ([S, 1] tokens) against the
    paged cache. Returns (next_tokens [S, 1], updated cache)."""
    logits, cache = decode_step_logits_paged(params, cfg, tokens, cache)
    return torch.argmax(logits[:, None, :], dim=-1).to(torch.int32), cache
