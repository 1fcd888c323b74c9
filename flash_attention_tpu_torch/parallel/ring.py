"""Ring attention: sequence-parallel attention with KV rotation between ranks.

Counterpart of the JAX package's ``parallel/ring.py`` on
``torch.distributed``. Each rank of the context group holds one shard of
the sequence; KV shards rotate rank to rank around the group
(``parallel.mesh.Rotation``, ``batch_isend_irecv`` to the next rank), and
each step's partial attention (K1 with its base-2 LSE) combines with
``ops.merge.merge_two``. The rotate for step s + 1 is posted before step
s's kernel, so over NCCL the transfer overlaps the kernel.

Causal attention over contiguous shards decomposes by block position:
  * step 0: the local diagonal chunk -> causal K1;
  * step s > 0, a chunk from an earlier rank -> non-causal K1;
  * step s > 0, a chunk from a later rank -> fully masked, skipped (a Python
    ``if`` on the rank; the chunk still rotates).

ZIGZAG layout (``zigzag=True``, causal only): rank i holds the global
chunks {i, 2n-1-i} of S/(2n) rows each, early chunk first, so every rank
does the same work every step: after the local causal step, the late query
half always attends the arriving early KV half, and exactly one of (early
q, early kv) and (late q, late kv) is live. ``zigzag_indices`` lays a
global sequence out that way.

The backward (``_RingAttention``, a ``torch.autograd.Function``) is a second
rotation: each (query shard, KV chunk) pair runs the backward kernels
(``ops.attention_bwd.flash_attention_bwd``: K3 when q heads == kv heads,
else K4 + K5) against the ring's merged output and global LSE, which makes
each pair's recomputed P the global softmax probabilities and its
gradients exact partial sums; the pairs' results come back in the input
dtype and add into fp32 dq / dk / dv, the dk / dv accumulators travel
with their KV chunk, and one final hop returns them to their owner.

The callables work on each rank's local shard (the contract of
``parallel/sharding.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from flash_attention_tpu_torch.ops.attention_bwd import flash_attention_bwd
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.ops.merge import merge_two
from flash_attention_tpu_torch.parallel.mesh import Exchange, Rotation, rotate


def zigzag_indices(seq_len: int, n: int) -> torch.Tensor:
    """Global -> zigzag gather indices: shard i holds chunks {i, 2n-1-i}.

    Returns an int64 [seq_len] tensor ``idx`` such that ``x[..., idx, :]``
    lays the sequence out in zigzag shard order (shard 0's [chunk 0 | chunk
    2n-1], shard 1's [chunk 1 | chunk 2n-2], ...). seq_len must divide
    evenly into 2n chunks.
    """
    if seq_len % (2 * n):
        raise ValueError(f"seq_len={seq_len} not divisible by 2n={2 * n}")
    chunks = torch.arange(seq_len).reshape(2 * n, seq_len // (2 * n))
    return torch.cat([chunks[j] for i in range(n) for j in (i, 2 * n - 1 - i)])


def inverse_permutation(idx: torch.Tensor) -> torch.Tensor:
    """Indices that undo a gather by ``idx`` (zigzag -> global order)."""
    return torch.argsort(idx)


def zigzag_data_layout(seq_len: int, n_ctx: int):
    """One-time data-loader permutation for zigzag ring-attention training.

    Returns ``(idx, positions)``: gather indices laying a ``[..., S]`` batch
    out in zigzag shard order (``tokens[:, idx]``), and the RoPE positions of
    the permuted tokens (the same values, int32). Permute tokens and targets
    once per batch, feed ``positions`` to RoPE, keep every activation in
    zigzag layout and call ``ring_flash_attention(zigzag=True)`` directly:
    per-token losses do not depend on the order, so nothing is permuted
    back, unlike ``make_ring_attention``'s wrapper, which moves q, k, v
    and the output (and their gradients) between the layouts each call.
    """
    idx = zigzag_indices(seq_len, n_ctx)
    return idx, idx.to(torch.int32)


def _attend(q, k, v, causal: bool, sm_scale: float):
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, save_residuals=True)


def _pair(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """fp32 (dq, dk, dv) of one (query shard, KV chunk) pair against the
    ring's merged o and global LSE."""
    return [g.float() for g in flash_attention_bwd(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)]


def _halves(x):
    """The early and late chunks of a zigzag shard (dim 2: q, k, v, o's rows
    and the LSE's)."""
    c = x.shape[2] // 2
    return x[:, :, :c], x[:, :, c:]


def _group(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _ring_forward(q, k, v, group, causal: bool, sm_scale: float, zigzag: bool):
    """(o in q's dtype, the ring-combined base-2 LSE fp32)."""
    n, me = _group(group)
    pending = Rotation([k, v], group) if n > 1 else None
    o, lse = _attend(q, k, v, causal, sm_scale)
    o = o.float()
    if zigzag:
        (o_e, o_l), (lse_e, lse_l), (q_e, q_l) = _halves(o), _halves(lse), _halves(q)
    for step in range(1, n):
        k_blk, v_blk = pending.wait()
        pending = Rotation([k_blk, v_blk], group) if step + 1 < n else None
        if zigzag:
            (k_e, k_l), (v_e, v_l) = _halves(k_blk), _halves(v_blk)
            o_l, lse_l = merge_two(o_l, lse_l, *_attend(q_l, k_e, v_e, False, sm_scale))
            if me >= step:  # the arriving chunk (me - step) mod n is earlier: early q x early kv
                o_e, lse_e = merge_two(o_e, lse_e, *_attend(q_e, k_e, v_e, False, sm_scale))
            else:  # late q x late kv
                o_l, lse_l = merge_two(o_l, lse_l, *_attend(q_l, k_l, v_l, False, sm_scale))
        elif not causal or me >= step:
            o, lse = merge_two(o, lse, *_attend(q, k_blk, v_blk, False, sm_scale))
    if zigzag:
        o, lse = torch.cat([o_e, o_l], dim=2), torch.cat([lse_e, lse_l], dim=2)
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, o, lse, do, group, causal: bool, sm_scale: float, zigzag: bool):
    """(dq, dk, dv) in q's, k's and v's dtypes: the second rotation. Each
    step posts the next KV chunk's hop and the accumulators' hop, runs its
    pairs into temporaries, then adds them into the accumulators that
    arrived, so both hops overlap the step's kernels."""
    n, me = _group(group)
    pending = Rotation([k, v], group) if n > 1 else None
    dq, dk, dv = _pair(q, k, v, o, lse, do, causal, sm_scale)
    if zigzag:
        c = q.shape[2] // 2
        (q_e, q_l), (o_e, o_l), (lse_e, lse_l), (do_e, do_l) = (_halves(x) for x in (q, o, lse, do))
    for step in range(1, n):
        k_blk, v_blk = pending.wait()
        pending = Rotation([k_blk, v_blk], group) if step + 1 < n else None
        arriving = Rotation([dk, dv], group, tag=2)  # the held chunk's accumulators (tags apart from k, v)
        parts = []  # (query rows, kv rows, fp32 partials)
        if zigzag:
            (k_e, k_l), (v_e, v_l) = _halves(k_blk), _halves(v_blk)
            parts.append((slice(c, None), slice(None, c), _pair(q_l, k_e, v_e, o_l, lse_l, do_l, False, sm_scale)))
            if me >= step:
                parts.append((slice(None, c), slice(None, c), _pair(q_e, k_e, v_e, o_e, lse_e, do_e, False, sm_scale)))
            else:
                parts.append((slice(c, None), slice(c, None), _pair(q_l, k_l, v_l, o_l, lse_l, do_l, False, sm_scale)))
        elif not causal or me >= step:
            parts.append((slice(None), slice(None), _pair(q, k_blk, v_blk, o, lse, do, False, sm_scale)))
        dk, dv = arriving.wait()
        for rows_q, rows_kv, (dq_s, dk_s, dv_s) in parts:
            dq[:, :, rows_q] += dq_s
            dk[:, :, rows_kv] += dk_s
            dv[:, :, rows_kv] += dv_s
    if n > 1:  # one shard behind their owner after n - 1 hops
        dk, dv = rotate([dk, dv], group, tag=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring with its backward: the forward's K1 calls run without grad
    (their LSE is not differentiable) and save (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, sm_scale: float, zigzag: bool):
        o, lse = _ring_forward(q, k, v, group, causal, sm_scale, zigzag)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.sm_scale, ctx.zigzag = group, causal, sm_scale, zigzag
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, o, lse, do.to(q.dtype), ctx.group, ctx.causal, ctx.sm_scale, ctx.zigzag)
        return *grads, None, None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group, causal: bool = False,
                         sm_scale: float | None = None, zigzag: bool = False) -> torch.Tensor:
    """Ring attention over this rank's shards. Differentiable in q, k, v.

    Args:
      q, k, v: the local shards [B, H, S/N, D] (Hq % Hkv == 0); the sequence
        is sharded over the N ranks of ``group`` in rank order (rank i holds
        positions [i*S/N, (i+1)*S/N)), or, with ``zigzag=True``, in zigzag
        order (rank i holds global chunks {i, 2N-1-i} of S/2N rows, early
        chunk first; ``zigzag_indices``).
      group: the context axis's process group (``mesh.get_group("context")``),
        which forms the ring.
      causal, sm_scale: as in ``flash_attention``.
      zigzag: the balanced causal layout (requires causal=True).

    Returns:
      [B, Hq, S/N, D], the output of the local query shard, in its layout.
    """
    if zigzag and not causal:
        raise ValueError("zigzag layout only applies to causal attention")
    if zigzag and q.shape[2] % 2:
        raise ValueError(f"zigzag needs an even local sequence (two chunks), got {q.shape[2]}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RingAttention.apply(q, k, v, group, causal, sm_scale, zigzag)
    return _ring_forward(q, k, v, group, causal, sm_scale, zigzag)[0]


def _chunks(n: int, zigzag: bool) -> list[list[int]]:
    """The two global chunks of S/2n rows each rank holds, in order: rank i
    holds {2i, 2i+1} in order, or {i, 2n-1-i} in zigzag layout."""
    return [[i, 2 * n - 1 - i] if zigzag else [2 * i, 2 * i + 1] for i in range(n)]


def _relayout(x, group, to_zigzag: bool):
    """This rank's shard (dim 2) moved from the in-order layout into the
    zigzag one, or back: each chunk of S/2N rows goes point to point to the
    rank that holds it in the other layout, so a rank holds O(S/N) rows."""
    n, me = _group(group)
    src, dst = _chunks(n, not to_zigzag), _chunks(n, to_zigzag)
    home = {c: (r, j) for r, cs in enumerate(dst) for j, c in enumerate(cs)}
    mine, out, sends = _halves(x), [None, None], []
    for j, c in enumerate(src[me]):
        r, slot = home[c]
        if r == me:
            out[slot] = mine[j]
        else:
            sends.append((mine[j], r, slot))  # tagged with its slot on the receiver
    owner = {c: r for r, cs in enumerate(src) for c in cs}
    recvs = [(mine[0], owner[c], slot) for slot, c in enumerate(dst[me]) if out[slot] is None]
    sends.sort(key=lambda s: (s[1], s[2]))  # each pair of ranks posts its transfers in slot order on both sides
    for (_, _, slot), t in zip(recvs, Exchange(sends, recvs, group).wait()):
        out[slot] = t
    return torch.cat(out, dim=2)


class _Relayout(torch.autograd.Function):
    """``_relayout``, differentiable: the gradient takes the opposite move."""

    @staticmethod
    def forward(ctx, x, group, to_zigzag: bool):
        ctx.group, ctx.to_zigzag = group, to_zigzag
        return _relayout(x, group, to_zigzag)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _relayout(g, ctx.group, not ctx.to_zigzag), None, None


def make_ring_attention(mesh, *, causal: bool = False, sm_scale: float | None = None, context_axis: str = "context",
                        model_axis: str = "model", data_axis: str = "data", zigzag: bool = False):
    """Ring attention over [B, H, S, D] with S sharded on the context axis
    (contiguous, in order), H on the model axis and B on the data axis: a
    callable over this rank's shards, with ``in_specs`` / ``out_spec`` as in
    ``parallel/sharding.py``. Differentiable.

    With ``zigzag=True`` (causal only) the callable moves its in-order
    shards into the zigzag layout and the output back (each chunk of S/2N
    rows point to point to its rank in the other layout), so callers see
    ordinary in-order shards. A training loop should rather keep
    activations in zigzag layout (``zigzag_data_layout``) and call
    ``ring_flash_attention`` directly.
    """
    spec = (data_axis, model_axis, context_axis, None)

    def local(q, k, v):
        group = mesh.get_group(context_axis)
        if not zigzag:
            return ring_flash_attention(q, k, v, group=group, causal=causal, sm_scale=sm_scale)
        if q.shape[2] % 2:
            raise ValueError(f"zigzag needs an even local sequence (two chunks), got {q.shape[2]}")
        q, k, v = (_Relayout.apply(x, group, True) for x in (q, k, v))
        out = ring_flash_attention(q, k, v, group=group, causal=causal, sm_scale=sm_scale, zigzag=True)
        return _Relayout.apply(out, group, False)

    local.in_specs, local.out_spec = (spec, spec, spec), spec
    return local
