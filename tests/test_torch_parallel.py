"""The mesh and the sharding factories (parallel/mesh.py, sharding.py) on
gloo CPU ranks against the JAX package's on its 8 virtual CPU devices.

The JAX package's tests/test_parallel.py cases on the port: the mesh
helpers; head- and batch-sharded attention (data 2 x model 4, causal and
not) and GQA co-location (8 q / 4 kv heads over model 4); context-parallel
attention (model 2 x context 4, and data 2 x model 2 x context 2); sharded
decode over a plain and an int8 cache (data 2 x model 4); plus
``cross_chip_merge`` on partials with rows that one rank, or every rank,
left empty (LSE -inf), and each factory on a one-rank mesh, bit-identical
to the single-process call it wraps.

As in tests/test_torch_ring.py, the port's side runs once for the module
in 8 gloo processes (``spawn_ranks``; this module imports no JAX at the
top) with the plain kernel versions, and rank 0 returns the gathered global
results; the JAX side runs in the test's process, its Pallas kernels in
interpret mode at S <= 256. fp32, within 1e-4 (sums in another order differ
by about 1e-7; a merge that drops or double-counts a shard moves the output
by more than 1e-2).
"""

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.utils.distributed import spawn_ranks

TOL = 1e-4
WORLD = 8
D = 128
MERGE_PARTS = 4  # context ranks of the merge case
LENGTHS = np.array([256, 130], np.int32)


def _uniform(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, s).astype(np.float32) for s in shapes]


# name: (mesh (data, model, context), factory, its keywords, the inputs' seed and shapes)
CASES = {
    "head and batch": ((2, 4, 1), "flash", dict(causal=False), (51, [(2, 8, 256, D)] * 3)),
    "head and batch causal": ((2, 4, 1), "flash", dict(causal=True), (51, [(2, 8, 256, D)] * 3)),
    "gqa colocation": ((1, 4, 1), "flash", dict(causal=True), (52, [(1, 8, 256, D)] + [(1, 4, 256, D)] * 2)),
    "context parallel": ((1, 2, 4), "context", {}, (53, [(1, 2, 256, D)] * 3)),
    "context parallel batch sharded": ((2, 2, 2), "context", {}, (56, [(2, 2, 256, D)] * 3)),
    "sharded decode": ((2, 4, 1), "decode", {}, (57, [(2, 8, D)] + [(2, 8, 256, D)] * 2)),
    "sharded decode int8": ((2, 4, 1), "decode", dict(kv_quant="int8"), (58, [(2, 8, D)] + [(2, 8, 256, D)] * 2)),
}


def _merge_parts():
    """Each context rank's partial (o [1, 2, 16, 32], base-2 LSE): rank r
    saw nothing of rows r and 5 + r, and no rank saw row 15."""
    o = _uniform(70, (MERGE_PARTS, 1, 2, 16, 32))[0]
    lse = np.random.default_rng(71).uniform(-3.0, 6.0, (MERGE_PARTS, 1, 2, 16)).astype(np.float32)
    for r in range(MERGE_PARTS):
        lse[r, :, :, [r, 5 + r]] = -np.inf
    lse[:, :, :, 15] = -np.inf
    return o, lse


def _factory(kind, mesh, kw):
    from flash_attention_tpu_torch.parallel import sharding

    if kind == "flash":
        return sharding.make_sharded_flash_attention(mesh, **kw)
    if kind == "context":
        return sharding.make_context_parallel_attention(mesh, **kw)
    return sharding.make_sharded_decode_attention(mesh)


def _port_args(name):
    _, kind, kw, (seed, shapes) = CASES[name]
    args = [torch.from_numpy(x) for x in _uniform(seed, *shapes)]
    if kind == "decode":
        if "kv_quant" in kw:
            from flash_attention_tpu_torch.ops.quant import quantize_kv

            args[1:] = quantize_kv(args[1], args[2], kw["kv_quant"])
        args.append(torch.from_numpy(LENGTHS))
    return args


def _port_side() -> dict:
    """Every case on this rank; rank 0's dict holds the gathered results."""
    import torch.distributed as dist

    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.parallel.mesh import auto_mesh, gather, make_mesh, shard
    from flash_attention_tpu_torch.parallel.sharding import cross_chip_merge

    torch.set_num_threads(1)
    out = {
        "meshes": [(m.mesh_dim_names, tuple(m.shape)) for m in (
            make_mesh(data=2, model=4, device_type="cpu"), auto_mesh(8, num_kv_heads=4, device_type="cpu"),
            auto_mesh(8, device_type="cpu"), auto_mesh(6, num_kv_heads=4, device_type="cpu"))],
    }
    try:
        make_mesh(3, 3, device_type="cpu")
    except ValueError as e:
        out["too big"] = str(e)

    for name, (mesh_shape, kind, kw, _) in CASES.items():
        mesh = make_mesh(*mesh_shape, device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        fn = _factory(kind, mesh, {k: v for k, v in kw.items() if k != "kv_quant"})
        args = [shard(x, mesh, spec) for x, spec in zip(_port_args(name), fn.in_specs)]
        out[name] = gather(fn(*args), mesh, fn.out_spec).numpy()

    mesh = make_mesh(1, 1, MERGE_PARTS, device_type="cpu")
    if mesh.get_coordinate() is not None:
        o, lse = _merge_parts()
        rank = mesh.get_coordinate()[2]
        merged = cross_chip_merge(torch.from_numpy(o[rank]), torch.from_numpy(lse[rank]), mesh.get_group("context"))
        out["merge"] = [gather(x[None], mesh, ("context",)).numpy() for x in merged]

    # A one-rank mesh: each factory equals its single-process call bit for bit.
    mesh = make_mesh(device_type="cpu")
    if dist.get_rank() == 0:
        q, k, v = (torch.from_numpy(x) for x in _uniform(60, (1, 8, 128, D), (1, 2, 128, D), (1, 2, 128, D)))
        lengths = torch.tensor([100])
        same = {
            "flash": torch.equal(_factory("flash", mesh, dict(causal=True))(q, k, v),
                                 flash_attention(q, k, v, causal=True)),
            "context": torch.equal(_factory("context", mesh, {})(q, k, v), flash_attention(q, k, v)),
            "decode": torch.equal(_factory("decode", mesh, {})(q[:, :, 0], k, v, lengths),
                                  decode_attention(q[:, :, 0], k, v, lengths)),
        }
        out["one rank"] = same
    return out if dist.get_rank() == 0 else {}


@pytest.fixture(scope="module")
def port():
    return spawn_ranks(_port_side, WORLD, backend="gloo", timeout_s=300)[0]


def test_mesh_helpers(port):
    names = ("data", "model", "context")
    assert port["meshes"] == [(names, (2, 4, 1)), (names, (2, 4, 1)), (names, (1, 8, 1)), (names, (3, 2, 1))]
    assert "need 9 processes, have 8" in port["too big"]


def _jax_side(name):
    import jax.numpy as jnp

    from flash_attention_tpu.ops.quant import quantize_kv
    from flash_attention_tpu.parallel.mesh import make_mesh
    from flash_attention_tpu.parallel.sharding import (
        make_context_parallel_attention,
        make_sharded_decode_attention,
        make_sharded_flash_attention,
    )

    mesh_shape, kind, kw, (seed, shapes) = CASES[name]
    mesh = make_mesh(*mesh_shape)
    args = [jnp.asarray(x) for x in _uniform(seed, *shapes)]
    if kind == "flash":
        return make_sharded_flash_attention(mesh, **kw)(*args)
    if kind == "context":
        return make_context_parallel_attention(mesh)(*args)
    if "kv_quant" in kw:
        args[1:] = quantize_kv(args[1], args[2], kw["kv_quant"])
    return make_sharded_decode_attention(mesh, block_kv=128)(*args, jnp.asarray(LENGTHS))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_factories_match_jax(port, name):
    want = np.asarray(_jax_side(name))
    assert port[name].shape == want.shape
    assert np.abs(port[name] - want).max() <= TOL


def test_cross_chip_merge_matches_jax(port):
    """Rows empty on one rank take the others' parts; a row empty on every
    rank gives output 0 and LSE -inf."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from flash_attention_tpu.parallel.mesh import make_mesh
    from flash_attention_tpu.parallel.sharding import cross_chip_merge

    o, lse = _merge_parts()
    merge = jax.shard_map(
        lambda o, lse: tuple(x[None] for x in cross_chip_merge(o[0], lse[0], "context")),
        mesh=make_mesh(1, 1, MERGE_PARTS), in_specs=(P("context"), P("context")),
        out_specs=(P("context"), P("context")), check_vma=False,
    )
    want_o, want_lse = (np.asarray(x) for x in merge(jnp.asarray(o), jnp.asarray(lse)))
    got_o, got_lse = port["merge"]
    assert np.abs(got_o - want_o).max() <= TOL
    finite = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(got_lse), finite) and np.abs(got_lse[finite] - want_lse[finite]).max() <= TOL
    assert (got_o[..., 15, :] == 0).all() and np.isneginf(got_lse[..., 15]).all()


def test_one_rank_mesh_is_the_single_process_call(port):
    assert port["one rank"] == {"flash": True, "context": True, "decode": True}
