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

Tensor-parallel serving, JAX's ``shard_caches`` (where GSPMD shards the
jitted model after a cache placed on the mesh): ``make_cache_sharding``
builds the callable both engines take, which keeps this rank's block of
the caches and carries its mesh (an engine given it makes only that
block; ``.gather`` makes the global caches of the blocks again, and the
engine's caches carry the callable, ``with_sharding``, for the
checkpoints), and ``shard_model_params`` gives the
engine this rank's share of the params: column-parallel q / k / v and
gate / up projections, row-parallel output and down projections (the
models' ``tp_group`` all-reduce follows each), the embedding and norms
whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from flash_attention_tpu_torch.ops.decode import decode_attention
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.ops.paged import PagedModelCache
from flash_attention_tpu_torch.ops.quant import QuantizedTensor
from flash_attention_tpu_torch.parallel.mesh import all_reduce_, axis_size, gather, shard


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


# Each projection's dimension split over the model axis, and whether it is
# row-parallel (its output, model_dim, whole on every rank): wq / wk / wv
# [model_dim, H, D] and wo [Hq, D, model_dim] by heads, w_gate / w_up
# [model_dim, mlp] by columns, w_down [mlp, model_dim] by rows.
_SPLIT = {"wq": (1, False), "wk": (1, False), "wv": (1, False), "wo": (0, True),
          "w_gate": (1, False), "w_up": (1, False), "w_down": (0, True)}


def _shard_weight(w, mesh, name: str, model_axis: str):
    """This rank's block of the weight ``name``. A W8A16 weight's scales
    (one an output channel) split with the columns, and stay whole on a
    row-parallel weight."""
    dim, row_parallel = _SPLIT[name]
    spec = tuple(model_axis if d == dim else None for d in range(len(w.shape)))
    if isinstance(w, QuantizedTensor) and row_parallel:
        return QuantizedTensor(shard(w.values, mesh, spec), w.scales)
    return shard(w, mesh, spec)


def shard_model_params(params: dict, cfg, mesh, *, model_axis: str = "model"):
    """This rank's share of a model's params for tensor-parallel serving, and
    the config it runs under (the rank's head counts and MLP width).

    ``wq`` / ``wk`` / ``wv`` [model_dim, H, D] split by heads and ``wo``
    [Hq, D, model_dim] by heads (row-parallel); ``w_gate`` / ``w_up``
    [model_dim, mlp] by columns and ``w_down`` [mlp, model_dim] by rows
    (row-parallel); the tied embedding and the norms stay whole (the same
    tensors). A W8A16 weight's scales split with its output columns and stay
    whole where the output is not split. The model axis must divide
    ``num_kv_heads``, so each rank's q heads stay with their kv head
    (``auto_mesh``'s rule); the mesh's other axes take no part.
    """
    m = axis_size(mesh, model_axis)
    if cfg.num_kv_heads % m or cfg.mlp_dim % m:
        raise ValueError(f"the model axis ({m} ranks) must divide num_kv_heads ({cfg.num_kv_heads}) and mlp_dim "
                         f"({cfg.mlp_dim})")

    def layer(lp):
        return {**lp, "attn": {n: _shard_weight(w, mesh, n, model_axis) for n, w in lp["attn"].items()},
                "mlp": {n: _shard_weight(w, mesh, n, model_axis) for n, w in lp["mlp"].items()}}

    local = {**params, "layers": [layer(lp) for lp in params["layers"]]}
    return local, dataclasses.replace(cfg, num_q_heads=cfg.num_q_heads // m, num_kv_heads=cfg.num_kv_heads // m,
                                      mlp_dim=cfg.mlp_dim // m)


def make_cache_sharding(mesh, *, data_axis: str = "data", model_axis: str = "model"):
    """The engines' ``shard_caches`` for tensor-parallel serving over ``mesh``.

    The callable keeps this rank's block of the fresh global caches: dense
    ``KVCache``s (plain or quantized, rolling included) [B, Hkv, S, D] over
    (data, model) and lengths over data, as JAX's
    tests/test_sharded_serving.py places them; a ``PagedModelCache``'s
    pools [L, pages, Hkv, page, D] and their scales over kv heads, its page
    table and lengths whole, so over a data axis the paged engine's ranks
    are replicas. It carries ``.mesh``, ``.data_axis`` and ``.model_axis``,
    from which an engine shards its params (``shard_model_params``), takes
    its groups and makes this rank's block of its fresh caches directly;
    ``.gather(blocks)``, which every rank of the mesh calls with its own
    block, returns the global caches on each (``parallel.mesh.gather``), and
    ``.global_shapes(blocks)`` the global caches' layout as meta tensors,
    without communication.
    """
    kv_spec = (data_axis, model_axis, None, None)
    pool_spec = (None, None, model_axis, None, None)

    def each(caches, fn):
        """``caches`` with every sharded tensor ``x`` replaced by ``fn(x, spec)``."""

        def one(x, spec):
            return None if x is None else fn(x, spec)

        if isinstance(caches, PagedModelCache):
            return PagedModelCache(one(caches.k_pool, pool_spec), one(caches.v_pool, pool_spec), caches.page_table,
                                   caches.lengths, one(caches.k_scales, pool_spec[:-1]),
                                   one(caches.v_scales, pool_spec[:-1]))
        return [c._replace(k=one(c.k, kv_spec), v=one(c.v, kv_spec), lengths=one(c.lengths, (data_axis,)),
                           k_scales=one(c.k_scales, kv_spec), v_scales=one(c.v_scales, kv_spec)) for c in caches]

    def global_shape(x, spec):
        shape = [n * (1 if name is None else axis_size(mesh, name)) for n, name in zip(x.shape, spec)]
        return torch.empty(shape, dtype=x.dtype, device="meta")

    def shard_caches(caches):
        return each(caches, lambda x, spec: shard(x, mesh, spec))

    shard_caches.gather = lambda caches: each(caches, lambda x, spec: gather(x, mesh, spec))
    shard_caches.global_shapes = lambda caches: each(caches, global_shape)
    shard_caches.mesh, shard_caches.data_axis, shard_caches.model_axis = mesh, data_axis, model_axis
    return shard_caches


class ShardedCaches(list):
    """A dense engine's per-layer caches, this rank's block of them, with
    the ``make_cache_sharding`` callable that placed them (``.sharding``)."""

    sharding = None


class ShardedPagedModelCache(PagedModelCache):
    """A paged engine's ``PagedModelCache``, this rank's kv heads of its
    pools, with the ``make_cache_sharding`` callable that placed them
    (``.sharding``; a ``_replace`` of it carries none)."""

    sharding = None


def with_sharding(caches, sharding):
    """``caches`` carrying ``sharding`` when it is a ``make_cache_sharding``
    callable (one with a mesh), else ``caches`` as they are: the tree
    ``utils/checkpoint`` gathers before it writes and shards as it reads."""
    if getattr(sharding, "mesh", None) is None:
        return caches
    out = ShardedPagedModelCache(*caches) if isinstance(caches, PagedModelCache) else ShardedCaches(caches)
    out.sharding = sharding
    return out
