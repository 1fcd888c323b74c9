"""Fused attention forward: kernels K1, K1d and K2 and their plain version.

Replaces the JAX package's ``ops/flash_attention.py:_fwd_kernel`` and, for a
causal sliding window no wider than the kernel's 64-row kv tile,
``_band_kernel`` (:795, K2), both reached from ``flash_attention`` (:1718),
with their sliding-window, logit-softcap and segment-id branches (K1d:
packed sequences, each document attending only within itself). In bf16 and
fp16 all three run the tensor-core body of csrc/flash_fwd_sm90.cu (wgmma on
TMA-fed tiles, P rounded to the input type before P V, q tiles of
``fwd_q_tile`` rows, the kv walk of ``fwd_walk``); in fp32 they run the FMA
body of csrc/flash_fwd.cu (K2 there walks two unaligned tiles).
What bounds the kernels on an H100 (tensor-core arithmetic at long kv, K2's
bytes) and what each design does about it is written at the top of each
source.

A prefill chunk reads its cache through ``cache_attention``: over a slot of
the dense cache K1 (``flash_attention``'s ``kv_batch`` form), over a
quantized one K1q, over the rolling ring K1r (16-bit or quantized, its sinks
in the same pass), each reading the cache where it lies. They stand for the
JAX package's ``_fwd_kernel`` fed by the XLA dequant and ring gather of its
chunk prefill (``models/attention.py:438-511``), which copy the visible rows
first; that copy is now only ``cache_attention_plain``'s, the function they
compute. In bf16 / fp16, K1q and K1r run csrc/chunk_fwd_sm90.cu: a block
takes a kv head and its GQA group's q heads as rows packed by (position,
head) (``chunk_rows``), a producer warpgroup loads (and widens) each K / V
tile once for the group, and the walk (``fwd_walk``) is cut into
``chunk_splits`` shares (``chunk_shares``), one a block of a thread-block
cluster, merged in rank order; ``cache_attention_split_plain`` is that
cut's plain mirror.

``flash_attention`` runs the plain PyTorch version for CPU tensors and the
CUDA kernel for CUDA tensors; there is no fallback from one to the other.
``flash_attention.launches`` counts K1 launches,
``flash_attention.band_launches`` K2's and
``flash_attention.segment_launches`` K1d's (any call with segment ids);
``.tensor_core_launches`` and ``.fma_launches`` count them again by the body
that ran; ``cache_attention.quant_launches`` counts K1q's,
``.ring_launches`` K1r's (a quantized ring's too), its own
``.tensor_core_launches`` and ``.fma_launches`` both by body, and
``.cluster_launches`` those of the tensor-core body launched as clusters of
more than one block.

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
    check_bulk_scales,
    mask_window,
    ring_layout,
    ring_rows,
    segment_operands,
    segment_pair,
    slot_index,
    slot_rows,
    sm_count,
    softcap2,
    tma_operands,
    visible_mask,
)
from flash_attention_tpu_torch.ops.counters import body_counter, counter
from flash_attention_tpu_torch.ops.decode import check_tma_rows
from flash_attention_tpu_torch.ops.merge import merge_two
from flash_attention_tpu_torch.ops.quant import bits

# K2 takes a causal window no wider than the kernels' 64-row kv tile.
BAND_MAX_WINDOW = 64
# The kv rows a step of the kernels' walk (csrc/flash_fwd_sm90.cu and
# csrc/flash_fwd.cu BN).
KV_TILE = 64


def fwd_q_tile(batch: int, num_q_heads: int, q_len: int, num_sms: int) -> int:
    """q rows a block of the tensor-core body takes (K1, K1d, K2, K8): 128
    (two warpgroups sharing each K / V tile) where that gives at least one
    block an SM, else 64 (one warpgroup, two blocks an SM), so a short chunk
    still fills the card: q [1,32,256,128] makes 64 blocks of 128 rows on an
    H100's 132 SMs, 128 of 64."""
    return 128 if -(-q_len // 128) * batch * num_q_heads >= num_sms else 64


def fwd_body(dtype: torch.dtype) -> str:
    """The body a CUDA forward call (K1, K1d, K2, K1q, K1r, or K8 over any
    pages) launches for queries of ``dtype``: "tensor_core"
    (csrc/flash_fwd_sm90.cu) in bf16 / fp16, "fma" (csrc/flash_fwd.cu) in
    fp32. A paged 1-byte payload (K8q) widens exactly to the query's type for
    Q K and to bf16 for P V; a dense one (K1q, K1r) dequantizes to the
    query's type, as the chunk prefill's plain version does."""
    return "tensor_core" if dtype in TENSOR_CORE_DTYPES else "fma"


def fwd_route(dtype: torch.dtype, sliding_window=None, has_segments: bool = False) -> tuple[str, str]:
    """The kernel a CUDA call of ``flash_attention`` launches, and its body:
    K1d with segment ids, K2 for a window of at most BAND_MAX_WINDOW without
    them, else K1; and ``fwd_body``."""
    if has_segments:
        kernel = "K1d"
    elif sliding_window is not None and sliding_window <= BAND_MAX_WINDOW:
        kernel = "K2"
    else:
        kernel = "K1"
    return kernel, fwd_body(dtype)


def fwd_walk(m0: int, q_tile: int, q_len: int, kv_len: int, *, window=None, sinks: int = 0,
             ring: bool = False) -> list[int]:
    """The first positions of the kv tiles (KV_TILE rows each) that the
    tensor-core body's causal block of q rows [m0, m0 + q_tile) walks, in
    order, as csrc/flash_fwd_sm90.cu cuts them (without segment ids): the
    tiles holding [0, sinks) below the band, then from the tile of the
    block's first row's first visible column to the causal diagonal of its
    last row, on the grid from 0, or on the ring (K1r) from ``sinks``. A
    paged kv (K8) reads tile n0 from page n0 // page_size, the ring tile n0
    from ``ops.common.ring_rows``' row of n0 (n0 itself below the sinks)."""
    diag = kv_len - q_len
    n_end = min(kv_len, min(m0 + q_tile, q_len) + diag)
    origin = sinks if ring else 0
    w_lo = max(0, m0 + diag - window + 1) if window else 0
    n_begin = origin + max(0, w_lo - origin) // KV_TILE * KV_TILE if window else 0
    sink_end = min(-(-sinks // KV_TILE) * KV_TILE, n_begin) if window else 0
    return [*range(0, min(sink_end, n_end), KV_TILE), *range(n_begin, n_end, KV_TILE)]


# Each forward kernel's launch counter on ``flash_attention``.
_COUNTERS = {"K1": "launches", "K2": "band_launches", "K1d": "segment_launches"}
# The CUDA functions a forward launch runs: csrc/flash_fwd_sm90.cu's body, csrc/chunk_fwd_sm90.cu's (K1q, K1r in
# bf16 / fp16), or csrc/flash_fwd.cu's; the trace tells the kernels apart only by template arguments.
FWD_FUNCTIONS = ("fwd_kernel", "chunk_fwd_kernel", "flash_fwd_kernel")

# csrc/chunk_fwd_sm90.cu (K1q, K1r in bf16 / fp16): packed (position, head)
# rows a block, the head dims it is instantiated for, and the largest
# cluster the walk is split over (the portable size).
CHUNK_ROWS = 128
CHUNK_HEAD_DIMS = (64, 128)
CHUNK_MAX_SPLITS = 8


def chunk_q_tiles(t: int, group: int) -> int:
    """The blocks of CHUNK_ROWS packed rows a kv head's T x group rows take."""
    return -(-t * group // CHUNK_ROWS)


def chunk_splits(num_kv_heads: int, t: int, group: int, num_sms: int) -> int:
    """The blocks of a cluster csrc/chunk_fwd_sm90.cu cuts each walk over, as
    ``fwd_q_tile`` picks its tile: as many as keep every block of the launch
    in one wave on ``num_sms`` SMs (one block an SM), from 1 to
    CHUNK_MAX_SPLITS. The chunk q [1,32,256,128] over 8 kv heads is 64
    (kv head, q tile) pairs: 2 on an H100's 132 SMs, 128 blocks."""
    base = num_kv_heads * chunk_q_tiles(t, group)
    return max(1, min(CHUNK_MAX_SPLITS, num_sms // base))


def chunk_rows(m0: int, t: int, group: int) -> tuple[list[int], list[int]]:
    """The (position, q head within the group) of packed rows [m0, m0 +
    CHUNK_ROWS) of a kv head: row r is position r // group of head r %
    group; rows at positions >= T are padding (zero Q, never stored)."""
    rows = range(m0, m0 + CHUNK_ROWS)
    return [r // group for r in rows], [r % group for r in rows]


def chunk_walk(m0: int, t: int, group: int, kv_end: int, *, window=None, sinks: int = 0,
               ring: bool = False) -> list[int]:
    """The kv tiles the block of packed rows [m0, m0 + CHUNK_ROWS) walks:
    ``fwd_walk`` over its positions (m0 // group to the last one below
    T)."""
    first, last = m0 // group, min((m0 + CHUNK_ROWS - 1) // group, t - 1)
    return fwd_walk(first, last - first + 1, t, kv_end, window=window, sinks=sinks, ring=ring)


def chunk_shares(walk: list[int], splits: int) -> list[list[int]]:
    """The walk cut into ``splits`` contiguous shares in order, share r its
    tiles [r n // splits, (r + 1) n // splits) (some empty when the walk is
    shorter than the split), as the cluster's rank-r block walks them."""
    n = len(walk)
    return [walk[r * n // splits:(r + 1) * n // splits] for r in range(splits)]


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


def _validate(q, k, v, causal, sliding_window, logit_softcap, kv_batch=None):
    """The input checks of the JAX wrapper (ops/flash_attention.py:1761-1779),
    and ``kv_batch``'s: an int32 [batch] tensor on q's device."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected [batch, heads, seq, head_dim] inputs")
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if (kv_batch is None and k.shape[0] != batch) or k.shape[3] != head_dim:
        raise ValueError(f"q/kv shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if kv_batch is not None and (kv_batch.shape != (batch,) or kv_batch.dtype != torch.int32
                                 or kv_batch.device != q.device):
        raise ValueError(f"kv_batch: want int32 [{batch}] on {q.device}, got {kv_batch.dtype} "
                         f"{tuple(kv_batch.shape)} on {kv_batch.device}")
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
    segments=None, kv_batch=None,
):
    """K1 (K2 for a window of at most BAND_MAX_WINDOW, K1d with segment ids)
    for CUDA tensors, the plain version for CPU tensors (with ``kv_batch``
    over K's and V's rows picked by ``index_select``)."""
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads, kv_len = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        if kv_batch is not None:
            k, v = k.index_select(0, kv_batch), v.index_select(0, kv_batch)
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
        with _build.on_device(q.device):
            err = lib.fat_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                *(None if t is None else t.data_ptr() for t in seg),
                None if kv_batch is None else kv_batch.contiguous().data_ptr(), k.shape[0],
                batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                sm_scale * LOG2E, int(causal), mask_window(sliding_window), softcap2(logit_softcap),
                int(kernel == "K2"),
                _build.DTYPE_CODES[q.dtype], _build.current_stream(q.device), q_tile,
            )
        _build.check(err, f"flash_attention ({kernel})")
        counter = _COUNTERS[kernel]
        setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
        setattr(flash_attention, f"{body}_launches", getattr(flash_attention, f"{body}_launches") + 1)
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
    kv_batch=None,
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
      kv_batch: None, or an int32 [batch] tensor on q's device: k and v then
        hold any number of batch rows (a whole [slots, kv_heads, rows,
        head_dim] KV cache, or a view of its first rows) and query batch b
        attends row kv_batch[b]. The kernel reads the index from device
        memory (a CUDA graph of the call serves every index; JAX's traced
        slot in ``dynamic_slice``); the plain version takes K's and V's rows
        by ``index_select``. Not with segment ids, nor under grad.
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
    _validate(q, k, v, causal, sliding_window, logit_softcap, kv_batch)
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    if kv_batch is not None and segments is not None:
        raise ValueError("flash_attention: kv_batch does not take segment ids")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if needs_grad and save_residuals:
        raise ValueError("flash_attention: save_residuals=True is not differentiable; call it under torch.no_grad()")
    if needs_grad and kv_batch is not None:
        raise ValueError("flash_attention: kv_batch is not differentiable; call it under torch.no_grad()")
    if needs_grad:
        q_ids, kv_ids = segments or (None, None)
        return FlashAttentionFunction.apply(q, k, v, causal, sm_scale, sliding_window, logit_softcap, q_ids, kv_ids)
    return _forward(q, k, v, causal, sm_scale, save_residuals, sliding_window, logit_softcap, segments, kv_batch)


def cache_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slot: torch.Tensor, kv_end: int, *, sm_scale: float,
    k_scales=None, v_scales=None, ring: bool = False, sinks: int = 0, sliding_window: int | None = None,
    logit_softcap: float | None = None, save_residuals: bool = False,
):
    """The function K1 (``kv_batch`` form), K1q and K1r compute, as the JAX
    package's chunk prefill computes it (``models/attention.py:438-511``):
    the slot's visible rows copied out in position order (the dense prefix,
    or on the ring the last min(kv_end, window + T) positions), a quantized
    payload dequantized to q's dtype, then ``flash_attention_plain`` causal
    with the masks; on the ring with sinks past the window, the band pass
    and a non-causal pass over the sinks, merged by their base-2 LSE
    (``merge_two``). ``slot``: a [1] int32 tensor on the cache's device."""
    t = q.shape[2]
    rows = k.shape[2]

    def dequant(vis, scales):
        return vis if scales is None else (vis.float() * scales).to(q.dtype)

    def gather(lo, hi):
        """The slot's rows holding positions [lo, hi), in position order, as
        [1, Hkv, n, D] K and V (a copy)."""
        idx = ring_rows(torch.arange(lo, hi, device=k.device), rows, sinks)
        return tuple(
            dequant(bits(buf)[slot_rows(buf, slot, idx)].view(buf.dtype),
                    None if sc is None else sc[slot_rows(sc, slot, idx)])
            for buf, sc in ((k, k_scales), (v, v_scales))
        )

    def attend(kv, causal, window, lse):
        return flash_attention_plain(q, *kv, causal=causal, sm_scale=sm_scale, save_residuals=lse,
                                     sliding_window=window, logit_softcap=logit_softcap)

    if ring and sinks and kv_end > sliding_window:
        # Every row attends the sinks and its window band: the band pass and
        # the sink pass (every chunk past the window starts at or after the
        # sinks), merged by LSE.
        g = min(sliding_window + t, kv_end - sinks)
        o_band, lse_band = attend(gather(kv_end - g, kv_end), True, sliding_window, True)
        o_sink, lse_sink = attend(gather(0, sinks), False, None, True)
        o, lse = merge_two(o_band, lse_band, o_sink, lse_sink)
        o = o.to(q.dtype)
        return (o, lse) if save_residuals else o
    if ring:
        # Only the last min(kv_end, window + T) positions are visible (with
        # sinks, kv_end <= window here, so nothing has rolled out yet).
        g = min(kv_end, sliding_window + t)
        kv = gather(kv_end - g, kv_end)
    elif k_scales is not None:
        kv = tuple(
            dequant(bits(buf)[:, :, :kv_end].index_select(0, slot).view(buf.dtype),
                    sc[:, :, :kv_end].index_select(0, slot))
            for buf, sc in ((k, k_scales), (v, v_scales))
        )
    else:
        kv = (k[:, :, :kv_end].index_select(0, slot), v[:, :, :kv_end].index_select(0, slot))
    return attend(kv, True, sliding_window, save_residuals)


def chunk_merge_plain(partials):
    """The per-share partials of one block's rows, [(acc [R, D], m [R], l
    [R]), ...] in rank order (acc unnormalised, m the base-2 running max
    floored at M_FLOOR, l the sum of exp2(s - m)), merged as the cluster's
    first block merges them, one rank after another in fp32: (out [R, D], the
    base-2 LSE [R]), 0 and -inf for a row that saw no key."""
    acc, m, l = partials[0]
    for acc2, m2, l2 in partials[1:]:
        mn = torch.maximum(m, m2)
        a0, a1 = torch.exp2(m - mn), torch.exp2(m2 - mn)
        l = l * a0 + l2 * a1
        acc = acc * a0[:, None] + acc2 * a1[:, None]
        m = mn
    out = torch.where(l[:, None] == 0, 0.0, acc / torch.where(l == 0, 1.0, l)[:, None])
    return out, torch.where(l == 0, -torch.inf, m + torch.log2(torch.where(l == 0, 1.0, l)))


def cache_attention_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slot: int, kv_end: int, *, sm_scale: float, splits: int,
    k_scales=None, v_scales=None, ring: bool = False, sinks: int = 0, sliding_window: int | None = None,
    logit_softcap: float | None = None,
):
    """``cache_attention``'s function cut as csrc/chunk_fwd_sm90.cu cuts it,
    in plain fp32 PyTorch: for each kv head and block of packed (position,
    head) rows (``chunk_rows``), each of the ``splits`` shares of its walk
    (``chunk_shares`` of ``chunk_walk``) gives a partial (acc, m, l) over the
    share's tiles, each tile at n0 holding columns [n0, n0 + 64) read from
    the slot's rows of those positions (``ring_rows`` on the ring) and
    dequantized to q's type, with the kernel's limits (a sink tile's columns
    end at ``sinks``, any other's at kv_end) and the causal / window / sinks
    mask of each row's position; ``chunk_merge_plain`` merges them in rank
    order. Returns (out [1, Hq, T, D] in q's dtype, base-2 LSE [1, Hq, T])."""
    _, num_q_heads, t, head_dim = q.shape
    num_kv_heads, rows = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    diag = kv_end - t
    out = torch.zeros(q.shape, dtype=torch.float32)
    lse = torch.full((1, num_q_heads, t), -torch.inf)
    for hk in range(num_kv_heads):
        for m0 in range(0, t * group, CHUNK_ROWS):
            pos, head = (torch.tensor(x) for x in chunk_rows(m0, t, group))
            valid = pos < t
            heads, p_ok = hk * group + head, pos.clamp_max(t - 1)
            qr = torch.where(valid[:, None], q[0, heads, p_ok].float(), 0.0)
            walk = chunk_walk(m0, t, group, kv_end, window=sliding_window, sinks=sinks, ring=ring)
            partials = []
            for share in chunk_shares(walk, splits):
                if not share:
                    partials.append((torch.zeros(CHUNK_ROWS, head_dim), torch.full((CHUNK_ROWS,), M_FLOOR),
                                     torch.zeros(CHUNK_ROWS)))
                    continue
                cols = torch.cat([torch.arange(n0, n0 + KV_TILE) for n0 in share])
                # The walk's sink tiles (below the band, which starts at or past the sinks) end at the sinks.
                lim = torch.cat([torch.full((KV_TILE,), sinks if n0 < sinks else kv_end) for n0 in share])
                idx = ring_rows(cols, rows, sinks) if ring else cols.clamp_max(rows - 1)
                kv = []
                for buf, sc in ((k, k_scales), (v, v_scales)):
                    x = bits(buf)[slot, hk, idx].view(buf.dtype)
                    kv.append((x if sc is None else (x.float() * sc[slot, hk, idx]).to(q.dtype)).float())
                s = qr @ kv[0].T
                if logit_softcap is None:
                    s2 = s * (sm_scale * LOG2E)
                else:
                    s2 = logit_softcap * torch.tanh(s * sm_scale / logit_softcap) * LOG2E
                d = pos[:, None] + diag
                ok = valid[:, None] & (cols[None, :] < lim[None, :]) & (cols[None, :] <= d)
                if sliding_window is not None:
                    ok &= (cols[None, :] > d - sliding_window) | (cols[None, :] < sinks)
                s2 = torch.where(ok, s2, MASK_VALUE)
                m = s2.amax(dim=-1).clamp_min(M_FLOOR)
                p = torch.exp2(s2 - m[:, None])
                partials.append((p @ kv[1], m, p.sum(dim=-1)))
            o, l2 = chunk_merge_plain(partials)
            out[0, heads[valid], pos[valid]] = o[valid]
            lse[0, heads[valid], pos[valid]] = l2[valid]
    return out.to(q.dtype), lse


def cache_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slot, kv_end: int, *, k_scales=None, v_scales=None,
    ring: bool = False, sinks: int = 0, sliding_window: int | None = None, logit_softcap: float | None = None,
    save_residuals: bool = False,
):
    """A prefill chunk's causal attention over one slot of a dense KV cache,
    read where it lies (no gathered or dequantized copy).

    Args:
      q: [1, q_heads, T, head_dim], the chunk at positions [kv_end - T,
        kv_end); its own K / V already written to the cache.
      k, v: the whole cache [slots, kv_heads, rows, head_dim], the model's
        dtype or a 1-byte payload (int8, float8_e4m3fn, float8_e5m2) with
        ``k_scales`` / ``v_scales`` [slots, kv_heads, rows, 1] fp32.
      slot: the cache row attended, a host int or a one-element tensor on
        the device (the kernels read it from device memory, so one CUDA
        graph of a chunk serves every slot).
      kv_end: a host int, the exclusive end of the visible positions.
      ring: the rolling cache (``models/attention.py``): position p at row
        ``ops.common.ring_rows(p, rows, sinks)``; needs ``sliding_window``
        and a ring of at least window + T rows above the sinks' rows, whose
        rows are all finite (the kernels read whole tiles, the rows they
        mask out included; ``init_kv_cache`` zeroes the ring).
      sinks: StreamingLLM sinks (ring only): positions [0, sinks) visible
        beside the window.
      sliding_window, logit_softcap: as ``flash_attention``'s; the softmax
        scale is 1/sqrt(head_dim).
      save_residuals: also return the base-2 LSE [1, q_heads, T] fp32.

    For CPU tensors runs ``cache_attention_plain``; for CUDA tensors
    launches K1 (16-bit dense, ``flash_attention``'s ``kv_batch`` form; K2
    at a window of at most 64), K1q (quantized dense) or K1r (the ring,
    16-bit or quantized), or raises. K1q and K1r run csrc/chunk_fwd_sm90.cu
    in bf16 / fp16 (head_dim 64 or 128; the walk split over clusters of
    ``chunk_splits`` blocks), csrc/flash_fwd.cu in fp32. No gradient.

    Returns:
      [1, q_heads, T, head_dim] in q's dtype, plus the LSE if asked.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or q.shape[0] != 1:
        raise ValueError(f"cache_attention: want q [1, Hq, T, D] and a [slots, Hkv, rows, D] cache, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    _, num_q_heads, t, head_dim = q.shape
    slots, num_kv_heads, rows, _ = k.shape
    if k.shape != v.shape or k.shape[3] != head_dim or num_q_heads % num_kv_heads:
        raise ValueError(f"cache_attention: q {tuple(q.shape)} over k {tuple(k.shape)} / v {tuple(v.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("cache_attention: give both k_scales and v_scales, or neither")
    kv_end = int(kv_end)
    if kv_end < t:
        raise ValueError(f"cache_attention: kv_end={kv_end} < T={t}")
    if sinks and not ring:
        raise ValueError("cache_attention: sinks need the ring")
    ring_mod, ring_base = ring_layout(rows, sinks) if ring else (0, 0)
    if ring:
        if sliding_window is None:
            raise ValueError("cache_attention: the ring needs sliding_window")
        if ring_mod < sliding_window + t:
            raise ValueError(f"cache_attention: a ring of {ring_mod} rows above {ring_base} sink rows must hold "
                             f"window ({sliding_window}) + chunk ({t}) rows")
    elif kv_end > rows:
        raise ValueError(f"cache_attention: kv_end={kv_end} exceeds the cache's {rows} rows")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    sm_scale = 1.0 / math.sqrt(head_dim)
    slot = slot_index(slot, slots, q.device)
    if q.device.type == "cpu":
        return cache_attention_plain(
            q, k, v, slot, kv_end, sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales, ring=ring, sinks=sinks,
            sliding_window=sliding_window, logit_softcap=logit_softcap, save_residuals=save_residuals,
        )
    if q.device.type != "cuda":
        raise ValueError(f"cache_attention runs on cpu or cuda tensors, got {q.device}")
    if not ring and k_scales is None:
        # K1 over the slot's first kv_end rows, a strided view of the cache.
        return _forward(q, k[:, :, :kv_end], v[:, :, :kv_end], True, sm_scale, save_residuals, sliding_window,
                        logit_softcap, None, slot)
    payload = _build.kv_payload_code("cache_attention", head_dim, q, k, v, k_scales, v_scales)
    if ring and ring_mod % KV_TILE and kv_end - sinks > ring_mod:
        raise ValueError(f"cache_attention: the kernel walks the ring in {KV_TILE}-row tiles, so once positions have "
                         f"wrapped the ring's {ring_mod} rows above the sinks must be a multiple of {KV_TILE}")
    scales = [None if sc is None else sc.reshape(sc.shape[:3]) for sc in (k_scales, v_scales)]
    body = fwd_body(q.dtype)
    k, v = (_build.unit_last_stride(x) for x in (k, v))
    splits = 1
    if body == "tensor_core":
        if head_dim not in CHUNK_HEAD_DIMS:
            raise ValueError(f"cache_attention: the {q.dtype} kernel over a quantized cache or the ring takes head_dim "
                             f"in {CHUNK_HEAD_DIMS}, got {head_dim}")
        (q,) = tma_operands(q)
        check_tma_rows("cache_attention", k, v)
        if scales[0] is not None:
            check_bulk_scales("cache_attention", *scales)
        splits = chunk_splits(num_kv_heads, t, num_q_heads // num_kv_heads, sm_count(q.device))
    else:
        q = _build.unit_last_stride(q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((1, num_q_heads, t), dtype=torch.float32, device=q.device) if save_residuals else None
    strides = [0] * 6 if scales[0] is None else [*scales[0].stride(), *scales[1].stride()]
    lib = _build.kernels()
    entry = lib.fat_chunk_fwd if body == "tensor_core" else lib.fat_cache_fwd
    with _build.on_device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *(None if sc is None else sc.data_ptr() for sc in scales),
            out.data_ptr(), None if lse is None else lse.data_ptr(), slot.data_ptr(), slots, num_q_heads,
            num_kv_heads, t, kv_end, rows, head_dim, q.stride(1), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            _build.int64_tuple_array(tuple(strides)), sm_scale * LOG2E, mask_window(sliding_window), sinks,
            ring_mod, ring_base, softcap2(logit_softcap), _build.DTYPE_CODES[q.dtype], payload,
            _build.current_stream(q.device), splits,
        )
    kernel = "K1r" if ring else "K1q"
    _build.check(err, f"cache_attention ({kernel})")
    if ring:
        cache_attention.ring_launches += 1
    else:
        cache_attention.quant_launches += 1
    setattr(cache_attention, f"{body}_launches", getattr(cache_attention, f"{body}_launches") + 1)
    cache_attention.cluster_launches += splits > 1
    return (out, lse) if save_residuals else out


for _kernel, _attr in _COUNTERS.items():
    counter(flash_attention, _attr, _kernel, *FWD_FUNCTIONS)
body_counter(flash_attention, "tensor_core_launches", "K1/K1d/K2 tensor_core")  # on csrc/flash_fwd_sm90.cu
body_counter(flash_attention, "fma_launches", "K1/K1d/K2 fma")  # on csrc/flash_fwd.cu
counter(cache_attention, "quant_launches", "K1q", *FWD_FUNCTIONS)
counter(cache_attention, "ring_launches", "K1r", *FWD_FUNCTIONS)
body_counter(cache_attention, "tensor_core_launches", "K1q/K1r tensor_core")  # on csrc/chunk_fwd_sm90.cu
body_counter(cache_attention, "fma_launches", "K1q/K1r fma")  # on csrc/flash_fwd.cu
body_counter(cache_attention, "cluster_launches", "K1q/K1r cluster")  # chunk_fwd_sm90.cu over a cluster
