"""Fused attention forward: kernel K1 (csrc/flash_fwd.cu) and its plain version.

Replaces the JAX package's ``ops/flash_attention.py:_fwd_kernel``, reached
from ``flash_attention`` (:1718). What bounds the kernel on an H100 (tensor-
core arithmetic at long kv) and what its design does about it is written at
the top of csrc/flash_fwd.cu.

``flash_attention`` runs the plain PyTorch version for CPU tensors and the
CUDA kernel for CUDA tensors; there is no fallback from one to the other.
``flash_attention.launches`` counts kernel launches.

Under grad the call goes through ``FlashAttentionFunction``, the
counterpart of the JAX package's custom VJP (``_fa``/``_fa_fwd``/``_fa_bwd``,
:1650-1702): the forward runs once with its LSE and saves (q, k, v, out,
lse2), and the backward is ``ops/attention_bwd.flash_attention_bwd`` (K3, or
K4 + K5). The CPU takes the same Function with the plain forward and
backward, so the CPU tests run the card's wiring.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.attention_bwd import flash_attention_bwd
from flash_attention_tpu_torch.ops.common import LOG2E, M_FLOOR, MASK_VALUE


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    save_residuals: bool,
):
    """The function K1 computes, in plain fp32 PyTorch.

    Materialises the [B, Hq, Sq, Skv] scores: the kernel's contract (exp2
    softmax, finite mask, max floored at M_FLOOR, 0 output and -inf LSE for a
    row that sees no key) without its tiling.
    """
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    qf = q.float().reshape(batch, num_kv_heads, group, q_len, head_dim)
    s2 = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * (sm_scale * LOG2E)
    if causal:
        row = torch.arange(q_len, device=q.device)[:, None] + (kv_len - q_len)
        col = torch.arange(kv_len, device=q.device)[None, :]
        s2 = torch.where(col <= row, s2, MASK_VALUE)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = torch.where(l == 0, 0.0, acc / l).reshape(q.shape).to(q.dtype)
    if not save_residuals:
        return out
    lse = torch.where(l == 0, -torch.inf, m + torch.log2(l))
    return out, lse.reshape(batch, num_q_heads, q_len)


def _validate(q, k, v, causal):
    """The input checks of the JAX wrapper (ops/flash_attention.py:1761-1799)."""
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


def _forward(q, k, v, causal: bool, sm_scale: float, save_residuals: bool):
    """K1 for CUDA tensors, the plain version for CPU tensors."""
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, sm_scale=sm_scale, save_residuals=save_residuals
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")

    _build.check_operands("flash_attention", head_dim, q, k, v)
    q, k, v = (_build.unit_last_stride(x) for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch, num_q_heads, q_len), dtype=torch.float32, device=q.device)
        if save_residuals else None
    )
    if out.numel():
        lib = _build.kernels()
        with torch.cuda.device(q.device):
            err = lib.fat_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                sm_scale * LOG2E, int(causal), _build.DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(err, "flash_attention (K1)")
        flash_attention.launches += 1
    return (out, lse) if save_residuals else out


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the backward kernels: one forward with its LSE, then
    ``flash_attention_bwd`` on the saved residuals. The backward is not
    itself differentiable, on either device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse2 = _forward(q, k, v, causal, sm_scale, save_residuals=True)
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse2 = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse2, do, causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    save_residuals: bool = False,
):
    """Fused multi-head attention forward, differentiable in q, k and v.

    Args:
      q: [batch, q_heads, q_seq, head_dim].
      k, v: [batch, kv_heads, kv_seq, head_dim]; q_heads % kv_heads == 0.
        Any batch, head and row strides (a slice of a KV cache goes in as a
        view); the CUDA kernel copies an operand only if its last dimension
        is strided.
      causal: lower-triangular mask aligned so the last query row sees the
        whole KV sequence (the decode / chunked-prefill convention).
      sm_scale: softmax scale, default 1/sqrt(head_dim).
      save_residuals: also return the base-2 LSE [batch, q_heads, q_seq]
        fp32 (-inf for a row that sees no key). Not differentiable, as in
        the JAX package: under grad it raises.

    Returns:
      [batch, q_heads, q_seq, head_dim] in q's dtype, plus the LSE if asked.
    """
    _validate(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if needs_grad and save_residuals:
        raise ValueError("flash_attention: save_residuals=True is not differentiable; call it under torch.no_grad()")
    if needs_grad:
        return FlashAttentionFunction.apply(q, k, v, causal, sm_scale)
    return _forward(q, k, v, causal, sm_scale, save_residuals)


flash_attention.launches = 0
