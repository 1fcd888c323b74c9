"""Attention backward: kernels K3, K4 and K5 (csrc/flash_bwd.cu) and their plain version.

Counterpart of the JAX package's ``ops/attention_bwd.py:flash_attention_bwd``
(:978). Replaces its three Pallas kernels: ``_bwd_fused_kernel`` (K3, :594,
one pass for dq, dk and dv), ``_bwd_dq_kernel`` (K4, :65) and
``_bwd_dkv_kernel`` (K5, :317, dk and dv summed over the GQA group). What
bounds each on an H100 and what its design does about it is written at the
top of csrc/flash_bwd.cu.

The recurrence (S = Q Kᵀ, P recomputed from the forward's base-2 LSE):

    P = exp2(S · sm_scale · log2(e) − lse2)   under the forward's causal mask
    delta = rowsum(dO ∘ O)
    dV = Pᵀ dO;  dP = dO Vᵀ;  dS = P ∘ (dP − delta)
    dQ = sm_scale · dS K;  dK = sm_scale · dSᵀ Q

``flash_attention_bwd`` takes the plain version for CPU tensors and launches
the kernels for CUDA tensors; there is no fallback from one to the other. It
routes as the JAX package does: K3 for MHA self-attention (group 1, q_len ==
kv_len), K4 + K5 otherwise. ``launch_fused.launches``,
``launch_dq.launches`` and ``launch_dkv.launches`` count the launches of
K3, K4 and K5.
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import LOG2E

_MASK_ITEM = "ROADMAP.md queue 1 item 3 (window, softcap and segment ids of the backward)"


def bwd_route(num_q_heads: int, num_kv_heads: int, q_len: int, kv_len: int) -> str:
    """"fused" (K3) or "two_pass" (K4 + K5), the JAX package's choice
    (ops/attention_bwd.py:1239-1259 with ops/tuning.py:427-435): the fused
    kernel takes MHA self-attention only."""
    return "fused" if num_q_heads == num_kv_heads and q_len == kv_len else "two_pass"


def _guard_lse(lse2: torch.Tensor) -> torch.Tensor:
    """An LSE of -inf (a row that saw no key) becomes 0, so the row's masked
    scores recompute to P = 0 and give zero gradient, not NaN
    (ops/attention_bwd.py:1020)."""
    return torch.where(torch.isneginf(lse2), 0.0, lse2.float())


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO ∘ O) in fp32, [B, Hq, Sq] (ops/attention_bwd.py:1051-1053)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, out, lse2, do, *, causal: bool, sm_scale: float):
    """The function K3, K4 and K5 compute, in plain fp32 PyTorch.

    Materialises the [B, Hq, Sq, Skv] scores. Returns (dq, dk, dv) in the
    dtypes of q, k and v; dk and dv are summed over each kv head's group.
    """
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    shape5 = (batch, num_kv_heads, group, q_len, head_dim)
    qf = q.float().reshape(shape5)
    dof = do.float().reshape(shape5)
    kf, vf = k.float(), v.float()
    lse = _guard_lse(lse2).reshape(batch, num_kv_heads, group, q_len, 1)
    delta = _delta(out, do).reshape(batch, num_kv_heads, group, q_len, 1)
    s2 = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * (sm_scale * LOG2E)
    p = torch.exp2(s2 - lse)
    if causal:
        row = torch.arange(q_len, device=q.device)[:, None] + (kv_len - q_len)
        col = torch.arange(kv_len, device=q.device)[None, :]
        p = torch.where(col <= row, p, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sm_scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * sm_scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(*tensors) -> list[int]:
    return [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]


def _launch(entry: str, what: str, q, k, v, do, lse, delta, outs, *, causal, sm_scale) -> None:
    """One C entry of csrc/flash_bwd.cu over (q, k, v, dO, lse, delta) into
    the output tensors ``outs``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} launches on cuda tensors, got {q.device}")
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs),
            batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim,
            *_strides(q, k, v, do),
            sm_scale * LOG2E, sm_scale, int(causal), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, what)


# The three launchers take what flash_attention_bwd prepares: CUDA operands
# with a unit last stride, the guarded LSE and delta [B, Hq, Sq] fp32
# contiguous. Each counts its launches in ``.launches``.


def launch_fused(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float):
    """K3: (dq, dk, dv) of MHA self-attention in one pass. Each (kv tile, q
    tile) adds its dq partial into an fp32 buffer with atomics, so dq sums in
    a run-dependent order; dk and dv are written once."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("fat_flash_bwd_fused", "flash_attention_bwd (K3)", q, k, v, do, lse, delta, (dq_acc, dk, dv),
            causal=causal, sm_scale=sm_scale)
    launch_fused.launches += 1
    return dq_acc.to(q.dtype), dk, dv


def launch_dq(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float):
    """K4: dq, one block per 64-row q tile walking the kv tiles it sees."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("fat_flash_bwd_dq", "flash_attention_bwd (K4)", q, k, v, do, lse, delta, (dq,),
            causal=causal, sm_scale=sm_scale)
    launch_dq.launches += 1
    return dq


def launch_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float):
    """K5: (dk, dv) summed over the GQA group, one block per 64-row kv tile
    walking its group's q heads and the q tiles that see it."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("fat_flash_bwd_dkv", "flash_attention_bwd (K5)", q, k, v, do, lse, delta, (dk, dv),
            causal=causal, sm_scale=sm_scale)
    launch_dkv.launches += 1
    return dk, dv


launch_fused.launches = 0
launch_dq.launches = 0
launch_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse2: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    window: int | None = None,
    softcap: float | None = None,
    segments=None,
):
    """Compute (dq, dk, dv) from the forward's residuals.

    Args:
      q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0), with any
        batch, head and row strides.
      out: the forward output [B, Hq, Sq, D]; lse2: its base-2 LSE
        [B, Hq, Sq] fp32 (-inf for a row that saw no key).
      do: the output's cotangent, out's shape; a strided last dimension is
        copied.
      causal, sm_scale: as in the forward.
      window, softcap, segments: not ported yet; raise NotImplementedError.

    Returns:
      dq [B, Hq, Sq, D], dk and dv [B, Hkv, Skv, D], in q's, k's and v's dtypes.
    """
    for name, used in (("window", window), ("softcap", softcap), ("segments", segments)):
        if used is not None:
            raise NotImplementedError(f"{name}={used!r} is not ported yet: {_MASK_ITEM}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse2, do, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda tensors, got {q.device}")

    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    _build.check_operands("flash_attention_bwd", head_dim, q, k, v, do)
    q, k, v, do = (_build.unit_last_stride(x) for x in (q, k, v, do))
    lse = _guard_lse(lse2).contiguous()
    delta = _delta(out, do).contiguous()
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    args = (q, k, v, do, lse, delta)
    launch = dict(causal=causal, sm_scale=sm_scale)
    if bwd_route(num_q_heads, num_kv_heads, q_len, kv_len) == "fused":
        return launch_fused(*args, **launch)
    return (launch_dq(*args, **launch), *launch_dkv(*args, **launch))
