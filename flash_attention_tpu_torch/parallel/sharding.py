"""Head- and batch-parallel attention, context-parallel attention, and the
cross-rank LSE merge.

Counterpart of the JAX package's ``parallel/sharding.py``. Data
parallelism shards the batch, tensor parallelism shards attention heads
(no communication during attention: each rank runs the same kernel on its
shard), and context parallelism gives each rank a KV shard whose partial
attention merges across ranks through its base-2 LSE.

The contract, where JAX's factories return ``jit(shard_map(...))`` over
global arrays: each factory returns a callable over THIS RANK'S LOCAL
SHARDS, which every rank of the mesh calls with its own blocks. The
callable's ``in_specs`` and ``out_spec`` attributes place each argument and
the result on the mesh as a ``PartitionSpec`` does (one mesh axis name or
None a dimension), and ``parallel.mesh.shard`` / ``gather`` move a global
tensor to the blocks and back, so a caller holding global tensors writes
``gather(fn(*(shard(x, mesh, s) for x, s in zip(args, fn.in_specs))),
mesh, fn.out_spec)``. The collectives are ``parallel.mesh``'s, over each
mesh axis's process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from flash_attention_tpu_torch.ops.decode import decode_attention
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.parallel.mesh import all_reduce_


def _specs(fn, in_specs, out_spec):
    fn.in_specs, fn.out_spec = in_specs, out_spec
    return fn


def make_sharded_flash_attention(mesh, *, causal: bool = False, sm_scale: float | None = None,
                                 data_axis: str = "data", model_axis: str = "model"):
    """Head- and batch-sharded forward attention (K1 on each rank's shard).

    Q/K/V/O: [B, H, S, D] with B sharded over ``data_axis`` and H over
    ``model_axis``. GQA: KV heads shard over the same model axis, so the q
    heads land with their KV head as long as the model axis divides
    num_kv_heads (``shard`` raises otherwise). No collectives run. The
    callable is differentiable, as ``flash_attention`` is.
    """
    spec = (data_axis, model_axis, None, None)

    def local(q, k, v):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)

    return _specs(local, (spec, spec, spec), spec)


def make_sharded_decode_attention(mesh, *, sm_scale: float | None = None, data_axis: str = "data",
                                  model_axis: str = "model"):
    """Decode attention with the KV cache sharded over batch x heads (K6, or
    K6q over QuantizedTensor caches, on each rank's shard).

    q: [B, Hq, D]; caches: [B, Hkv, S, D] (plain or QuantizedTensor);
    lengths: [B] (sharded over data, whole over the model axis). No
    communication: the all-reduce, if any, belongs to the caller's output
    projection.
    """
    q_spec = (data_axis, model_axis, None)
    kv_spec = (data_axis, model_axis, None, None)

    def local(q, k, v, lengths):
        return decode_attention(q, k, v, lengths, sm_scale=sm_scale)

    return _specs(local, (q_spec, kv_spec, kv_spec, (data_axis,)), q_spec)


def cross_chip_merge(o_local: torch.Tensor, lse_local: torch.Tensor, group):
    """Combine per-rank partial attention over the ranks of ``group``.

    The split-K merge as collectives: the global max of the base-2 LSE
    (all_reduce MAX), exp2-domain weights, then one all_reduce SUM of the
    weighted outputs and the weights together. Rows no rank saw (LSE -inf
    everywhere) give output 0 and LSE -inf. Call on each rank with its
    ``flash_attention(..., save_residuals=True)`` over its KV shard.

    Returns (o in ``o_local``'s dtype, lse fp32).
    """
    m = all_reduce_(lse_local.float().clone(), dist.ReduceOp.MAX, group)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp2(lse_local.float() - m_safe)[..., None]  # -inf lse -> weight 0
    summed = all_reduce_(torch.cat([w * o_local.float(), w], dim=-1), dist.ReduceOp.SUM, group)
    o_sum, denom = summed[..., :-1], summed[..., -1]
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = o_sum / denom_safe[..., None]
    lse = torch.where(denom == 0.0, -torch.inf, m + torch.log2(denom_safe))
    return o.to(o_local.dtype), lse


def make_context_parallel_attention(mesh, *, sm_scale: float | None = None, data_axis: str = "data",
                                    context_axis: str = "context", model_axis: str = "model"):
    """Sequence-parallel (non-causal) attention: KV sharded over the context
    axis, Q whole along it; each rank runs K1 with its LSE against its KV
    shard and the partials merge with ``cross_chip_merge``. Batch shards over
    ``data_axis`` and heads over ``model_axis`` like the sibling factories.

    Forward only: ``flash_attention``'s LSE is not differentiable, so under
    grad the call raises. For causal self-attention use ring attention
    (parallel/ring.py), which balances the triangle and overlaps the KV
    movement with compute.
    """
    q_spec = (data_axis, model_axis, None, None)
    kv_spec = (data_axis, model_axis, context_axis, None)

    def local(q, k, v):
        o, lse = flash_attention(q, k, v, causal=False, sm_scale=sm_scale, save_residuals=True)
        return cross_chip_merge(o, lse, mesh.get_group(context_axis))[0]

    return _specs(local, (q_spec, kv_spec, kv_spec), q_spec)
