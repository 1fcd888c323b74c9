"""Attention backward: kernels K3, K4 and K5 and their plain version.

Counterpart of the JAX package's ``ops/attention_bwd.py:flash_attention_bwd``
(:978). Replaces its three Pallas kernels: ``_bwd_fused_kernel`` (K3, :594,
one pass for dq, dk and dv), ``_bwd_dq_kernel`` (K4, :65) and
``_bwd_dkv_kernel`` (K5, :317, dk and dv summed over the GQA group), with
their window, softcap and segment-id branches. In bf16 and fp16 all three
run the tensor-core bodies of csrc/flash_bwd_sm90.cu (wgmma on TMA-fed
tiles, P and dS rounded to the input type before their products); in fp32
they run the FMA bodies of csrc/flash_bwd.cu. What bounds each on an H100
and what its design does about it is written at the top of each source.

The recurrence (S = Q Kᵀ, P recomputed from the forward's base-2 LSE):

    P = exp2(S · sm_scale · log2(e) − lse2)   under the forward's mask
    delta = rowsum(dO ∘ O)
    dV = Pᵀ dO;  dP = dO Vᵀ;  dS = P ∘ (dP − delta)
    dQ = sm_scale · dS K;  dK = sm_scale · dSᵀ Q

The mask is the forward's: causal, a sliding window and segment ids. With a
logit softcap the score is the forward's capped one, cap · tanh(S · sm_scale
/ cap) · log2(e), and tanh's derivative folds into the score gradient: dS =
P ∘ (dP − delta) ∘ (1 − t²) with t = tanh(S · sm_scale / cap) (JAX :131-132,
:206-207, :239).

``flash_attention_bwd`` takes the plain version for CPU tensors and launches
the kernels for CUDA tensors; there is no fallback from one to the other. It
routes as the JAX package does: K3 for MHA self-attention (group 1, q_len ==
kv_len), K4 + K5 otherwise. ``launch_fused.launches``,
``launch_dq.launches`` and ``launch_dkv.launches`` count the launches of
K3, K4 and K5's unmasked instantiations, and ``.masked_launches`` those of
their masked ones (a window, a softcap or segment ids);
``launch_dkv_sum.launches`` counts K5's split sum (K5s), launched after K5
when ``dkv_splits`` splits a kv head's group over blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import (
    LOG2E,
    TENSOR_CORE_DTYPES,
    TMA_ALIGN,
    ceil_to,
    mask_window,
    segment_operands,
    sm_count,
    softcap2,
    tma_aligned,
    tma_operands,
    visible_mask,
)

DKV_TILE = 128  # kv rows a K5 (and K3) block of the tensor-core body owns
ROW_PAD = 64  # the tensor-core bodies read lse and delta in rows padded to this


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


def flash_attention_bwd_plain(
    q, k, v, out, lse2, do, *, causal: bool, sm_scale: float, window=None, softcap=None, segments=None
):
    """The function K3, K4 and K5 compute, in plain fp32 PyTorch.

    Materialises the [B, Hq, Sq, Skv] scores under the forward's mask (with
    ``segments`` a (q_ids, kv_ids) pair). Returns (dq, dk, dv) in the dtypes
    of q, k and v; dk and dv are summed over each kv head's group.
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
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    if softcap is None:
        s2 = scores * (sm_scale * LOG2E)
    else:
        t = torch.tanh(scores * (sm_scale / softcap))
        s2 = t * (softcap * LOG2E)
    p = torch.exp2(s2 - lse)
    ok = visible_mask(q_len, kv_len, q.device, causal=causal, window=window, segments=segments)
    if ok is not None:
        p = torch.where(ok[:, None, None], p, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sm_scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * sm_scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dkv_splits(batch: int, num_kv_heads: int, kv_len: int, group: int, num_sms: int) -> int:
    """How many blocks K5's tensor-core body splits each kv tile's GQA group
    (``group`` q heads) over: the smallest divisor of the group that gives
    at least two blocks an SM, else the whole group (one q head a block).
    One split writes dk and dv directly; more write fp32 partials that
    ``launch_dkv_sum`` adds."""
    blocks = -(-kv_len // DKV_TILE) * batch * num_kv_heads
    for splits in range(1, group + 1):
        if group % splits == 0 and blocks * splits >= 2 * num_sms:
            return splits
    return group


def _padded_rows(x: torch.Tensor) -> torch.Tensor:
    """lse or delta [B, Hq, Sq] fp32 with rows padded with 0 to a multiple of
    ROW_PAD columns and a 16-byte-aligned base (K5 copies 64 of them at a
    time); unchanged when it is so already."""
    pad = ceil_to(x.shape[-1], ROW_PAD) - x.shape[-1]
    if pad:
        x = F.pad(x, (0, pad))
    return x if x.data_ptr() % TMA_ALIGN == 0 else x.clone()


def _strides(*tensors) -> list[int]:
    return [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]


def _launch(entry: str, what: str, q, k, v, do, lse, delta, outs, *, causal, sm_scale, masks, tail=()) -> None:
    """One C entry of csrc/flash_bwd.cu over (q, k, v, dO, lse, delta) into
    the output tensors ``outs``, under ``masks`` (``BwdMasks``), with the
    entry's own trailing arguments ``tail``."""
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
            sm_scale * LOG2E, sm_scale, int(causal), *masks.c_args(), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream, *tail,
        )
    _build.check(err, what)


class BwdMasks:
    """The backward kernels' mask arguments for CUDA tensors on ``device``:
    window (None or >= 1), softcap (None or > 0) and segments (None or a
    (q_ids, kv_ids) pair, made int32 contiguous with their tile ranges).
    ``BwdMasks.NONE`` is the unmasked call; ``active`` says whether the
    kernels take their masked instantiation."""

    def __init__(self, window=None, softcap=None, segments=None, device=None):
        self.window, self.softcap = window, softcap
        self.seg = segment_operands(segments, device)
        self.active = window is not None or softcap is not None or segments is not None

    def count(self, launcher) -> None:
        """One launch of ``launcher``, counted by instantiation."""
        if self.active:
            launcher.masked_launches += 1
        else:
            launcher.launches += 1

    def c_args(self) -> list:
        return [
            mask_window(self.window), softcap2(self.softcap),
            *(None if t is None else t.data_ptr() for t in self.seg),
        ]


BwdMasks.NONE = BwdMasks()


# The three launchers take what flash_attention_bwd prepares: CUDA operands
# with a unit last stride, the guarded LSE and delta [B, Hq, Sq] fp32
# contiguous. Each counts its launches in ``.launches`` (unmasked) or
# ``.masked_launches``.


def launch_fused(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float, masks: BwdMasks = BwdMasks.NONE):
    """K3: (dq, dk, dv) of MHA self-attention in one pass, one block per kv
    tile (128 rows on the tensor cores in bf16 / fp16, 64 on FMAs in fp32)
    walking the q tiles that see it. Each (kv tile, q tile) adds its dq
    partial into a zeroed fp32 buffer of q's shape, contiguous (bulk
    reduces of D * 4-byte rows in bf16 / fp16, atomics in fp32), so dq sums
    in a run-dependent order; dk and dv are written once."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    args, pitch = _tensor_core_args(q, k, v, do, lse, delta)
    _launch("fat_flash_bwd_fused", "flash_attention_bwd (K3)", *args, (dq_acc, dk, dv),
            causal=causal, sm_scale=sm_scale, masks=masks, tail=(pitch,))
    masks.count(launch_fused)
    return dq_acc.to(q.dtype), dk, dv


def _tensor_core_args(q, k, v, do, lse, delta):
    """The operands as K3, K4 and K5 take them, with the lse / delta row pitch:
    for bf16 / fp16 (the tensor-core bodies) TMA-ready operands and padded
    rows, for fp32 (the FMA bodies) the operands as given."""
    if q.dtype not in TENSOR_CORE_DTYPES:
        return (q, k, v, do, lse, delta), q.shape[2]
    lse, delta = _padded_rows(lse), _padded_rows(delta)
    return (*tma_operands(q, k, v, do), lse, delta), lse.shape[-1]


def launch_dq(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float, masks: BwdMasks = BwdMasks.NONE):
    """K4: dq. In bf16 / fp16 one block per 128-row q tile on the tensor
    cores, in fp32 one per 64-row tile on FMAs, each walking the kv tiles it
    sees; each dq element is written once."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    args, pitch = _tensor_core_args(q, k, v, do, lse, delta)
    _launch("fat_flash_bwd_dq", "flash_attention_bwd (K4)", *args, (dq,),
            causal=causal, sm_scale=sm_scale, masks=masks, tail=(pitch,))
    masks.count(launch_dq)
    return dq


def launch_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float, masks: BwdMasks = BwdMasks.NONE):
    """K5: (dk, dv) summed over the GQA group, one block per kv tile (128
    rows on the tensor cores in bf16 / fp16, 64 on FMAs in fp32) walking its
    group's q heads and the q tiles that see it. In bf16 / fp16 the group is
    split over ``dkv_splits`` blocks; with more than one, they write fp32
    partials into a workspace that ``launch_dkv_sum`` adds in a fixed order."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    args, pitch = _tensor_core_args(q, k, v, do, lse, delta)
    batch, num_kv_heads, kv_len, head_dim = k.shape
    splits = 1
    if q.dtype in TENSOR_CORE_DTYPES:
        splits = dkv_splits(batch, num_kv_heads, kv_len, q.shape[1] // num_kv_heads, sm_count(q.device))
    ws = None
    if splits > 1:
        ws = torch.empty((2, batch, num_kv_heads, splits, kv_len, head_dim), dtype=torch.float32, device=q.device)
    _launch("fat_flash_bwd_dkv", "flash_attention_bwd (K5)", *args, (dk, dv),
            causal=causal, sm_scale=sm_scale, masks=masks, tail=(pitch, splits, None if ws is None else ws.data_ptr()))
    masks.count(launch_dkv)
    if ws is not None:
        launch_dkv_sum(ws, dk, dv)
    return dk, dv


def dkv_split_sum_plain(ws: torch.Tensor, dtype: torch.dtype):
    """What K5s computes, in plain PyTorch: the splits of ws [2, B, Hkv,
    splits, Skv, D] fp32 added in order 0, 1, ... in fp32, rounded to
    ``dtype``: (dk, dv)."""
    acc = ws[:, :, :, 0]
    for s in range(1, ws.shape[3]):
        acc = acc + ws[:, :, :, s]
    return acc[0].to(dtype), acc[1].to(dtype)


def launch_dkv_sum(ws: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor) -> None:
    """K5s (csrc/flash_bwd_sm90.cu ``split_sum_kernel``): dk and dv
    (contiguous, bf16 / fp16) from K5's split workspace ws [2, B, Hkv,
    splits, Skv, D] fp32, as ``dkv_split_sum_plain``. Deterministic."""
    if ws.device.type != "cuda":
        raise ValueError(f"the split sum launches on cuda tensors, got {ws.device}")
    _, batch, heads, splits, kv_len, head_dim = ws.shape
    with torch.cuda.device(ws.device):
        err = _build.kernels().fat_flash_bwd_dkv_sum(
            ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch * heads, splits, kv_len * head_dim,
            _build.DTYPE_CODES[dk.dtype], torch.cuda.current_stream(ws.device).cuda_stream,
        )
    _build.check(err, "flash_attention_bwd (K5 split sum)")
    launch_dkv_sum.launches += 1


launch_dkv_sum.launches = 0


for _launcher in (launch_fused, launch_dq, launch_dkv):
    _launcher.launches = 0
    _launcher.masked_launches = 0


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
      window, softcap: the forward's sliding window and logit softcap.
      segments: the forward's (q_ids [B, Sq], kv_ids [B, Skv]) pair, or None.

    Returns:
      dq [B, Hq, Sq, D], dk and dv [B, Hkv, Skv, D], in q's, k's and v's dtypes.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, out, lse2, do, causal=causal, sm_scale=sm_scale, window=window, softcap=softcap, segments=segments
        )
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
    launch = dict(causal=causal, sm_scale=sm_scale, masks=BwdMasks(window, softcap, segments, q.device))
    if bwd_route(num_q_heads, num_kv_heads, q_len, kv_len) == "fused":
        return launch_fused(*args, **launch)
    return (launch_dq(*args, **launch), *launch_dkv(*args, **launch))
