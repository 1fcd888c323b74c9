"""Fused attention forward: kernels K1, K1d and K2 and their plain version.

Replaces the JAX package's ``ops/flash_attention.py:_fwd_kernel`` and, for a
causal sliding window no wider than the kernel's 64-row kv tile,
``_band_kernel`` (:795, K2), both reached from ``flash_attention`` (:1718),
with their sliding-window, logit-softcap and segment-id branches (K1d:
packed sequences, each document attending only within itself). K1 and K1d
in bf16 and fp16 run the tensor-core body of csrc/flash_fwd_sm90.cu (wgmma
on TMA-fed tiles, P rounded to the input type before P V, q tiles of
``fwd_q_tile`` rows); in fp32 they, and K2 in every dtype, run the FMA body
of csrc/flash_fwd.cu. What bounds the kernels on an H100 (tensor-core
arithmetic at long kv) and what each design does about it is written at the
top of each source.

``flash_attention`` runs the plain PyTorch version for CPU tensors and the
CUDA kernel for CUDA tensors; there is no fallback from one to the other.
``flash_attention.launches`` counts K1 launches,
``flash_attention.band_launches`` K2's and
``flash_attention.segment_launches`` K1d's (any call with segment ids).

Under grad the call goes through ``FlashAttentionFunction``, the
counterpart of the JAX package's custom VJP (``_fa``/``_fa_fwd``/``_fa_bwd``,
:1650-1702): the forward runs once with its LSE and saves (q, k, v, out,
lse2) and the segment ids, and the backward is
``ops/attention_bwd.flash_attention_bwd`` (K3, or K4 + K5) under the same
window, softcap and ids. The CPU takes the same Function with the plain
forward and backward, so the CPU tests run the card's wiring.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.attention_bwd import flash_attention_bwd
from flash_attention_tpu_torch.ops.common import (
    LOG2E,
    M_FLOOR,
    MASK_VALUE,
    TENSOR_CORE_DTYPES,
    mask_window,
    segment_operands,
    segment_pair,
    sm_count,
    softcap2,
    tma_operands,
    visible_mask,
)

# K2 takes a causal window no wider than K1's kv tile (csrc/flash_fwd.cu BN).
BAND_MAX_WINDOW = 64


def fwd_q_tile(batch: int, num_q_heads: int, q_len: int, num_sms: int) -> int:
    """q rows a block of K1's tensor-core body takes: 128 (two warpgroups
    sharing each K / V tile) where that gives at least one block an SM, else
    64 (one warpgroup, two blocks an SM), so a short chunk still fills the
    card: q [1,32,256,128] makes 64 blocks of 128 rows on an H100's 132 SMs,
    128 of 64."""
    return 128 if -(-q_len // 128) * batch * num_q_heads >= num_sms else 64


def fwd_route(dtype: torch.dtype, sliding_window=None, has_segments: bool = False) -> tuple[str, str]:
    """The kernel a CUDA call of ``flash_attention`` launches, and its body:
    K1d with segment ids, K2 for a window of at most BAND_MAX_WINDOW without
    them, else K1; "tensor_core" (csrc/flash_fwd_sm90.cu) for K1 and K1d in
    bf16 / fp16, else "fma" (csrc/flash_fwd.cu: fp32, and K2's band walk in
    every dtype). K8 (ops/paged.py) keeps the FMA body too."""
    if has_segments:
        kernel = "K1d"
    elif sliding_window is not None and sliding_window <= BAND_MAX_WINDOW:
        kernel = "K2"
    else:
        kernel = "K1"
    return kernel, "tensor_core" if dtype in TENSOR_CORE_DTYPES and kernel != "K2" else "fma"


# Each forward kernel's launch counter on ``flash_attention``.
_COUNTERS = {"K1": "launches", "K2": "band_launches", "K1d": "segment_launches"}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    save_residuals: bool,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    sinks: int = 0,
    segments=None,
):
    """The function K1, K1d and K2 compute, in plain fp32 PyTorch.

    Materialises the [B, Hq, Sq, Skv] scores: the kernel's contract (exp2
    softmax, finite mask, max floored at M_FLOOR, 0 output and -inf LSE for a
    row that sees no key) without its tiling. The softcap maps the score to
    s2 = cap * tanh(qk * sm_scale / cap) * log2(e) before the mask; the
    window keeps column j for end-aligned row i when j > i + kv_len - q_len
    - window, and with ``sinks`` (K8's StreamingLLM sinks) also when j <
    sinks; ``segments``, a (q_ids [B, Sq], kv_ids [B, Skv]) pair, keeps only
    the pairs of equal ids.
    """
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    qf = q.float().reshape(batch, num_kv_heads, group, q_len, head_dim)
    if logit_softcap is None:
        s2 = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * (sm_scale * LOG2E)
    else:
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * sm_scale
        s2 = logit_softcap * torch.tanh(s / logit_softcap) * LOG2E
    ok = visible_mask(q_len, kv_len, q.device, causal=causal, window=sliding_window, sinks=sinks, segments=segments)
    if ok is not None:
        s2 = torch.where(ok[:, None, None], s2, MASK_VALUE)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = torch.where(l == 0, 0.0, acc / l).reshape(q.shape).to(q.dtype)
    if not save_residuals:
        return out
    lse = torch.where(l == 0, -torch.inf, m + torch.log2(l))
    return out, lse.reshape(batch, num_q_heads, q_len)


def _validate(q, k, v, causal, sliding_window, logit_softcap):
    """The input checks of the JAX wrapper (ops/flash_attention.py:1761-1779)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected [batch, heads, seq, head_dim] inputs")
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if k.shape[0] != batch or k.shape[3] != head_dim:
        raise ValueError(f"q/kv shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if causal and kv_len < q_len:
        raise ValueError("causal requires kv_seq >= q_seq")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal=True")
        if sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")


def _forward(
    q, k, v, causal: bool, sm_scale: float, save_residuals: bool, sliding_window=None, logit_softcap=None,
    segments=None,
):
    """K1 (K2 for a window of at most BAND_MAX_WINDOW, K1d with segment ids)
    for CUDA tensors, the plain version for CPU tensors."""
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, sm_scale=sm_scale, save_residuals=save_residuals,
            sliding_window=sliding_window, logit_softcap=logit_softcap, segments=segments,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")

    _build.check_operands("flash_attention", head_dim, q, k, v)
    kernel, body = fwd_route(q.dtype, sliding_window, segments is not None)
    tensor_core = body == "tensor_core"
    if tensor_core:
        q, k, v = tma_operands(q, k, v)
    else:
        q, k, v = (_build.unit_last_stride(x) for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch, num_q_heads, q_len), dtype=torch.float32, device=q.device)
        if save_residuals else None
    )
    if tensor_core and out.numel() and kv_len == 0:
        # No key: output 0 and LSE -inf, the contract's empty row (TMA takes
        # no empty tensor).
        out.zero_()
        if lse is not None:
            lse.fill_(-torch.inf)
    elif out.numel():
        seg = segment_operands(segments, q.device)
        q_tile = fwd_q_tile(batch, num_q_heads, q_len, sm_count(q.device)) if tensor_core else 0
        lib = _build.kernels()
        with torch.cuda.device(q.device):
            err = lib.fat_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                *(None if t is None else t.data_ptr() for t in seg),
                batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                sm_scale * LOG2E, int(causal), mask_window(sliding_window), softcap2(logit_softcap), int(kernel == "K2"),
                _build.DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream, q_tile,
            )
        _build.check(err, f"flash_attention ({kernel})")
        counter = _COUNTERS[kernel]
        setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return (out, lse) if save_residuals else out


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the backward kernels: one forward with its LSE, then
    ``flash_attention_bwd`` on the saved residuals under the forward's
    masks. The segment ids (q_ids, kv_ids; both None without segments) get
    no gradient, as the JAX package's float0 cotangents. The backward is not
    itself differentiable, on either device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, window, softcap, q_ids, kv_ids):
        segments = None if q_ids is None else (q_ids, kv_ids)
        out, lse2 = _forward(q, k, v, causal, sm_scale, True, window, softcap, segments)
        ctx.save_for_backward(q, k, v, out, lse2, q_ids, kv_ids)
        ctx.causal, ctx.sm_scale, ctx.window, ctx.softcap = causal, sm_scale, window, softcap
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse2, q_ids, kv_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse2, do, causal=ctx.causal, sm_scale=ctx.sm_scale, window=ctx.window,
            softcap=ctx.softcap, segments=None if q_ids is None else (q_ids, kv_ids),
        )
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    save_residuals: bool = False,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    segment_ids=None,
):
    """Fused multi-head attention forward, differentiable in q, k and v.

    Args:
      q: [batch, q_heads, q_seq, head_dim].
      k, v: [batch, kv_heads, kv_seq, head_dim]; q_heads % kv_heads == 0.
        Any batch, head and row strides (a slice of a KV cache goes in as a
        view); the CUDA kernel copies an operand only if its last dimension
        is strided or, in bf16 / fp16, if TMA cannot read it as it lies (a
        base or a stride not a multiple of 16 bytes).
      causal: lower-triangular mask aligned so the last query row sees the
        whole KV sequence (the decode / chunked-prefill convention).
      sm_scale: softmax scale, default 1/sqrt(head_dim).
      save_residuals: also return the base-2 LSE [batch, q_heads, q_seq]
        fp32 (-inf for a row that sees no key). Not differentiable, as in
        the JAX package: under grad it raises.
      sliding_window: causal only; row i also needs column j > i + kv_seq -
        q_seq - window (local attention, Mistral-style). A window of at most
        BAND_MAX_WINDOW runs K2 on the card.
      logit_softcap: > 0; scores become cap * tanh(score / cap) (Gemma-2).
      segment_ids: packed-sequence ids, one [batch, seq] integer tensor
        (needs q_seq == kv_seq) or a (q_ids [batch, q_seq], kv_ids [batch,
        kv_seq]) pair: a row sees only the columns of its own id, with
        causal and the window; a row whose id no column has gives 0 (and
        LSE -inf). Runs K1d on the card, whatever the window.
      Window, softcap and segment ids all hold under grad: the backward
      kernels apply the forward's mask.

    Returns:
      [batch, q_heads, q_seq, head_dim] in q's dtype, plus the LSE if asked.
    """
    _validate(q, k, v, causal, sliding_window, logit_softcap)
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if needs_grad and save_residuals:
        raise ValueError("flash_attention: save_residuals=True is not differentiable; call it under torch.no_grad()")
    if needs_grad:
        q_ids, kv_ids = segments or (None, None)
        return FlashAttentionFunction.apply(q, k, v, causal, sm_scale, sliding_window, logit_softcap, q_ids, kv_ids)
    return _forward(q, k, v, causal, sm_scale, save_residuals, sliding_window, logit_softcap, segments)


flash_attention.launches = 0
flash_attention.band_launches = 0
flash_attention.segment_launches = 0
