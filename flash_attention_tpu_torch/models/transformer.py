"""LLaMA-class decoder-only transformer built on the port's attention layer.

Counterpart of the JAX package's ``models/transformer.py``: the training
forward ``train_forward`` (no caches; differentiate it with autograd), and
the serving paths ``prefill``, ``prefill_chunk``, ``decode_step_logits`` and
``decode_step`` over dense caches, and their ``*_paged`` twins over the
paged model cache (``ops/paged.PagedModelCache``), with a params dict of
the JAX package's tree and shapes (``models/convert.py`` maps one onto the
other). The embedding is tied. With ``weight_quant="int8"`` the matmul
weights and the embedding are stored int8 with one fp32 scale per output
channel (per vocabulary row for the embedding), W8A16: each matmul's
weight is widened through bf16 (``ops/quant.w8_dequant``), as the JAX
package does. The JAX package leaves XLA to fuse that widen into the dot's
weight read; the port's counterpart is ``ops/quant.w8_matmul`` (W1 / W2 on
the card, reading the int8 payload; gate / up together through
``w8_matmul_group``), taken by every product with an int8 weight when no
gradient is needed; under autograd the weight is widened in memory first.

Matmuls with bf16 / fp32 weights stay ``torch.matmul`` / ``einsum``, as the
JAX package left them to XLA. One numerical difference: where JAX asks XLA
for fp32 products of bf16 operands (``preferred_element_type``) in the MLP, a
bf16 ``torch.matmul`` rounds its output to bf16. The tied unembed keeps its
product in fp32, as JAX's does. fp32 configurations are unaffected.

The serving entries take ``tp_group`` for a tensor-parallel model (a
rank's params and config from ``parallel.sharding.shard_model_params``):
see ``_trunk``. Training stays single-process, as in the JAX package.

Under autograd the norms and the SwiGLU activation are autograd Functions
(``_RMSNorm``, ``_SwiGLUAct``) with their gradients written out: they keep
their inputs in the model's dtype (and the norm's fp32 rstd), not the fp32
copies autograd would keep of the elementwise work in between, and their
backward runs no second forward. With no gradient to keep (serving), each
residual add and the norm after it are one call of ``ops.fused.
add_rms_norm`` and the activation one of ``swiglu_act`` (F1, F3 on the
card; 2 launches a layer plus 1 for the norms).
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
    attention_decode_paged,
    attention_decode_paged_deferred,
    attention_forward,
    attention_prefill,
    attention_prefill_chunk,
    attention_prefill_chunk_paged,
    attention_prefill_paged,
    init_attention_params,
    init_kv_cache,
    int8_product,
    matmul_f32,
    row_parallel,
    tensor_parallel,
)
from flash_attention_tpu_torch.ops.common import slot_index
from flash_attention_tpu_torch.ops.fused import add_rms_norm, rms_norm_plain, swiglu_act, swiglu_act_plain
from flash_attention_tpu_torch.ops.paged import PagedModelCache, init_paged_model_cache, paged_write_tokens_multi
from flash_attention_tpu_torch.ops.quant import (
    QuantizedTensor,
    quantize_weight,
    w8_matmul,
    w8_matmul_group,
    w8_matmul_plain,
)


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
    sliding_window: int | None = None  # Mistral-style local attention
    logit_softcap: float | None = None  # Gemma-2-style attention logit cap
    rolling: bool = False  # O(window) ring-buffer KV cache (needs sliding_window)
    attention_sinks: int = 0  # StreamingLLM sinks (dense: needs rolling)

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

    @staticmethod
    def tiny(**overrides) -> "ModelConfig":
        """A small config for tests / dryruns (the JAX package's defaults)."""
        defaults = dict(
            vocab_size=256, model_dim=256, num_layers=2, num_q_heads=8,
            num_kv_heads=4, head_dim=32, mlp_dim=512,
        )
        defaults.update(overrides)
        return ModelConfig(**defaults)


def _grad_needed(*args) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in args)


class _RMSNorm(torch.autograd.Function):
    """rms_norm under autograd, keeping x and the fp32 rstd for the backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rms_norm_plain(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        # Each product of a bf16 and an fp32 tensor runs in fp32 in one pass.
        x, weight, rstd = ctx.saved_tensors
        x_hat = x * rstd
        g = dy * weight.float()
        dx = torch.addcmul(g, x_hat, (g * x_hat).mean(dim=-1, keepdim=True), value=-1.0).mul_(rstd)
        dw = (dy * x_hat).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if _grad_needed(x, weight):
        return _RMSNorm.apply(x, weight, eps)
    return add_rms_norm(x, None, weight, eps)[1]


def _add_norm(x: torch.Tensor, delta, weight: torch.Tensor, eps: float):
    """(x + delta, the norm of it): one ``add_rms_norm`` call (F1) when no
    gradient is needed, else the add and ``_RMSNorm``."""
    if _grad_needed(x, weight, *(() if delta is None else (delta,))):
        x = x if delta is None else x + delta
        return x, _RMSNorm.apply(x, weight, eps)
    return add_rms_norm(x, delta, weight, eps)


class _SwiGLUAct(torch.autograd.Function):
    """silu(gate) * up under autograd, keeping gate and up for the backward."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu_act_plain(gate, up)

    @staticmethod
    def backward(ctx, da):
        gate, up = ctx.saved_tensors
        g, d = gate.float(), da.float()
        d_gate = torch.ops.aten.silu_backward(d * up, g)  # autograd's own silu gradient
        return d_gate.to(gate.dtype), (d * F.silu(g)).to(up.dtype)


def _product(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w in x's dtype; an int8 ``w`` through ``w8_matmul`` when no
    gradient is needed (``int8_product``)."""
    if int8_product(w, x):
        return w8_matmul(x, w)
    return torch.matmul(x, _weight(w, x.dtype))


def swiglu(x: torch.Tensor, params, tp_group=None) -> torch.Tensor:
    """The MLP; with ``tp_group``, over this rank's columns of gate / up and
    rows of the row-parallel down projection, summed over the group."""
    if int8_product(params["w_gate"], x) and int8_product(params["w_up"], x):
        gate, up = w8_matmul_group(x, (params["w_gate"], params["w_up"]))
    else:
        gate, up = _product(x, params["w_gate"]), _product(x, params["w_up"])
    act = _SwiGLUAct.apply(gate, up) if _grad_needed(gate, up) else swiglu_act(gate, up)
    w_down = params["w_down"]
    if not tensor_parallel(tp_group):
        return _product(act, w_down).to(x.dtype)
    return row_parallel(act, w_down if int8_product(w_down, act) else _weight(w_down, x.dtype), x.dtype, tp_group)


class _ProductF32(torch.autograd.Function):
    """``matmul_f32`` under autograd: the forward's product in fp32, the
    backward's as a product in x's dtype would have it (the output's
    gradient rounded to x's dtype), as autograd differentiated the rounded
    product before."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return dx, dw


def unembed(x: torch.Tensor, emb) -> torch.Tensor:
    """The tied unembed: fp32 logits [..., vocab] of x [..., model_dim]
    against the embedding [vocab, model_dim], the product kept in fp32 (the
    JAX package's ``preferred_element_type=float32``). An int8 embedding's
    per-row scale multiplies the fp32 sum (``w8_matmul`` with the scale on
    the output: W1 / W2 on the card)."""
    if isinstance(emb, QuantizedTensor):
        if int8_product(emb, x):
            return w8_matmul(x, emb, out_dtype=torch.float32, scale_on_output=True)
        return w8_matmul_plain(x, emb, out_dtype=torch.float32, scale_on_output=True)
    if _grad_needed(x, emb):
        return _ProductF32.apply(x, emb.t())
    return matmul_f32(x, emb.t())


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
            attn[name] = quantize_weight(attn[name], contract_axes=dims)
        mlp = {name: quantize_weight(w, contract_axes=0) for name, w in lp["mlp"].items()}
        return {**lp, "attn": attn, "mlp": mlp}

    return {
        **params,
        "embed": quantize_weight(params["embed"], contract_axes=1),
        "layers": [q_layer(lp) for lp in params["layers"]],
    }


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *, device, prefill_chunk: int = 0) -> list:
    """Every layer's zeroed KVCache; a rolling one holds window + one
    ``prefill_chunk`` of rows (``rolling_buffer_len``)."""
    acfg = cfg.attention_config()
    return [init_kv_cache(acfg, batch, max_seq, device=device, prefill_chunk=prefill_chunk) for _ in range(cfg.num_layers)]


def _trunk(params, cfg: ModelConfig, tokens: torch.Tensor, attn_fn, caches=None, tp_group=None):
    """Shared decoder trunk: embed -> N x (pre-norm attention via ``attn_fn``
    + pre-norm SwiGLU, both residual) -> final norm -> tied-embedding logits.

    ``attn_fn(layer_attn_params, acfg, h, cache, tp_group=...) -> (attn_out,
    new_cache)`` is the one piece the entry points differ in (cache is None
    throughout on the cache-free training path, ``caches=None``). With
    ``tp_group`` (tensor parallel: ``params`` and ``cfg`` are a rank's,
    from ``parallel.sharding.shard_model_params``) the attention and the MLP
    each end in an all-reduce over the group, so every rank of it holds the
    same residual stream, and the logits, from the replicated embedding and
    norms, are the same bits on each. Returns (logits [B, T, vocab] fp32,
    new caches).
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
    # Each residual add goes with the norm that follows it (_add_norm): the
    # MLP's output is added at the next layer's attention norm, the last
    # one at the final norm.
    layers = params["layers"]
    norms = [lp["attn_norm"] for lp in layers] + [params["final_norm"]]
    x, h = _add_norm(x, None, norms[0], cfg.norm_eps)
    for lp, cache, next_norm in zip(layers, caches, norms[1:]):
        attn_out, cache = attn_fn(lp["attn"], acfg, h, cache, tp_group=tp_group)
        x, h = _add_norm(x, attn_out, lp["mlp_norm"], cfg.norm_eps)
        x, h = _add_norm(x, swiglu(h, lp["mlp"], tp_group), next_norm, cfg.norm_eps)
        new_caches.append(cache)
    return unembed(h, emb), new_caches


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, *, decode: bool = False, tp_group=None):
    """Run the model over [B, T] tokens (T=1 when decode=True); every serving
    entry takes ``tp_group`` (``_trunk``).

    Returns (logits [B, T, vocab], updated caches).
    """
    attn = attention_decode if decode else attention_prefill
    return _trunk(params, cfg, tokens, attn, caches, tp_group)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, *, tp_group=None):
    return forward(params, cfg, tokens, caches, decode=False, tp_group=tp_group)


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-document RoPE positions for a packed [B, T] segment-id tensor:
    positions restart at 0 at every change of id (ids are contiguous runs),
    as the JAX package's ``segment_positions`` (``lax.cummax`` there,
    ``torch.cummax`` here)."""
    t = segment_ids.shape[-1]
    idx = torch.arange(t, device=segment_ids.device)[None, :]
    is_start = torch.cat(
        [torch.ones_like(segment_ids[:, :1], dtype=torch.bool), segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1
    )
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - seg_start


def train_forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, segment_ids=None) -> torch.Tensor:
    """Training-mode forward (no KV caches): causal LM logits [B, T, vocab]
    fp32 over [B, T] tokens; differentiate a loss of them with autograd.
    With ``segment_ids`` (packed pretraining batches) attention is masked
    per document and RoPE positions restart at each document's start;
    ``cfg``'s window and softcap apply throughout."""
    positions = None if segment_ids is None else segment_positions(segment_ids)

    def attn(p, acfg, h, cache, tp_group):
        return attention_forward(p, acfg, h, positions=positions, segment_ids=segment_ids), cache

    logits, _ = _trunk(params, cfg, tokens, attn)
    return logits


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, slot, start: int, kv_end: int, *,
                  tp_group=None):
    """Prefill ONE CHUNK ([1, T] tokens at positions [start, start+T)) of one
    sequence into its slot of the batched caches (start + T == kv_end).
    ``slot``: a host int or a one-element device tensor (JAX's traced slot),
    made one device index for every layer (``ops.common.slot_index``);
    ``start`` and ``kv_end`` host ints. Returns (logits [1, T, vocab],
    updated caches)."""
    slot = slot_index(slot, caches[0].k.shape[0], caches[0].k.device)
    return _trunk(
        params, cfg, tokens,
        lambda p, acfg, h, c, tp_group: attention_prefill_chunk(p, acfg, h, c, slot, start, kv_end, tp_group=tp_group),
        caches, tp_group,
    )


def decode_step_logits(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, *, tp_group=None):
    """One decode step returning raw last-position logits [B, vocab] (the
    sampling layer chooses the token; see serving/sampling.py)."""
    logits, caches = forward(params, cfg, tokens, caches, decode=True, tp_group=tp_group)
    return logits[:, -1, :], caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches: list, *, tp_group=None):
    """One greedy decode step: tokens [B, 1] -> (next_tokens [B, 1], caches)."""
    logits, caches = forward(params, cfg, tokens, caches, decode=True, tp_group=tp_group)
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


def _trunk_paged(params, cfg: ModelConfig, tokens: torch.Tensor, attn_fn, cache: PagedModelCache, tp_group=None):
    """``_trunk`` over the model cache's layer views. Every layer's write
    sets the same lengths, so the last layer's are the model's."""
    logits, layers = _trunk(params, cfg, tokens, attn_fn, cache.layers(), tp_group)
    return logits, cache._replace(lengths=layers[-1].lengths)


def prefill_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache, slot: int, true_len, *,
                  tp_group=None):
    """Prefill ONE sequence ([1, T] tokens, T a page multiple) into its slot's
    pages. Returns (logits [1, T, vocab], updated cache)."""
    return _trunk_paged(
        params, cfg, tokens,
        lambda p, acfg, h, c, tp_group: attention_prefill_paged(p, acfg, h, c, slot, true_len, tp_group=tp_group),
        cache, tp_group,
    )


def prefill_chunk_paged(
    params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache, slot, start: int, kv_end: int, *,
    tp_group=None,
):
    """Chunked prefill over the paged cache: [1, T] tokens at positions
    [start, start+T), T a page multiple, start + T == kv_end (host ints);
    ``slot`` a host int or a one-element device tensor, as in
    ``prefill_chunk``. Returns (logits [1, T, vocab], updated cache)."""
    slot = slot_index(slot, cache.page_table.shape[0], cache.page_table.device)
    return _trunk_paged(
        params, cfg, tokens,
        lambda p, acfg, h, c, tp_group: attention_prefill_chunk_paged(p, acfg, h, c, slot, start, kv_end,
                                                                      tp_group=tp_group),
        cache, tp_group,
    )


def decode_step_logits_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache, *,
                             tp_group=None):
    """One paged decode step returning raw last-position logits [S, vocab].

    The deferred-write path: every layer attends over the cache as it is,
    with the current token's self term merged in
    (``attention_decode_paged_deferred``, K7), and ALL layers' K/V rows land
    in one ``paged_write_tokens_multi`` launch (K10) after the layer stack.
    A window of 1 (the deferred window would be 0) takes the write-first
    path instead: each layer writes its row (K9), then K7 attends.
    """
    if cfg.sliding_window is not None and cfg.sliding_window <= 1:
        logits, cache = _trunk_paged(params, cfg, tokens, attention_decode_paged, cache, tp_group)
        return logits[:, -1, :], cache
    k_rows, v_rows = [], []

    def attn(lp, acfg, h, layer, tp_group):
        out, (k, v) = attention_decode_paged_deferred(lp, acfg, h, layer, tp_group=tp_group)
        k_rows.append(k)
        v_rows.append(v)
        return out, layer

    logits, _ = _trunk(params, cfg, tokens, attn, cache.layers(), tp_group)
    slots = torch.arange(tokens.shape[0], device=tokens.device)
    cache = paged_write_tokens_multi(cache, torch.stack(k_rows), torch.stack(v_rows), slots)
    return logits[:, -1, :], cache


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor, cache: PagedModelCache, *, tp_group=None):
    """One greedy decode step over all slots ([S, 1] tokens) against the
    paged cache. Returns (next_tokens [S, 1], updated cache)."""
    logits, cache = decode_step_logits_paged(params, cfg, tokens, cache, tp_group=tp_group)
    return torch.argmax(logits[:, None, :], dim=-1).to(torch.int32), cache
