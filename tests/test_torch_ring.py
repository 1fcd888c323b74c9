"""Ring attention (parallel/ring.py) on gloo CPU ranks against the JAX
package's ring on its 8 virtual CPU devices.

The JAX package's tests/test_parallel.py ring cases on the port: the
forward over contiguous and zigzag shards at a partial context axis (2
model x 4 context ranks) and the full one (8 context ranks), gradients of
causal / non-causal x contiguous / zigzag rings through
``make_ring_attention`` (and a GQA ring, which takes K4 + K5 where MHA
takes K3 on the card), the zigzag index round trip, and
``ring_flash_attention`` called directly on zigzag-layout shards as a
training loop keeps them.

The port's side runs once for the module: 8 processes (``spawn_ranks``,
gloo) each run every case on their shards with the plain kernel versions,
and rank 0 returns the gathered global outputs and gradients. This module
imports no JAX at the top, so each spawned rank starts without it; the
JAX side runs in the test's own process (the Pallas kernels in interpret
mode) at S <= 256, and larger shapes (and the GQA zigzag gradients, see
``ORACLE``) are held against the JAX package's oracle
``reference_attention``. fp32 throughout, within 1e-4 (the
training bar): the sums differ only in order, about 1e-7 here, while a
dropped or doubled chunk moves outputs and gradients by more than 1e-2.
"""

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.parallel.ring import inverse_permutation, zigzag_data_layout, zigzag_indices
from flash_attention_tpu_torch.utils.distributed import spawn_ranks

TOL = 1e-4
WORLD = 8
D = 128
# name: (mesh (data, model, context), q heads, kv heads, seq, causal, zigzag, with gradients)
CASES = {
    "contiguous": ((1, 2, 4), 2, 2, 256, False, False, False),
    "contiguous causal": ((1, 2, 4), 2, 2, 256, True, False, False),
    "zigzag": ((1, 2, 4), 2, 2, 256, True, True, False),
    "full axis causal": ((1, 1, 8), 2, 2, 1024, True, False, False),
    "full axis zigzag": ((1, 1, 8), 2, 2, 1024, True, True, False),
    "grad": ((1, 1, 4), 2, 2, 256, False, False, True),
    "grad causal": ((1, 1, 4), 2, 2, 256, True, False, True),
    "grad zigzag": ((1, 1, 4), 2, 2, 256, True, True, True),
    "grad causal gqa": ((1, 1, 4), 4, 2, 256, True, False, True),
    "grad zigzag gqa": ((1, 1, 4), 4, 2, 256, True, True, True),
}
# The JAX package's zigzag backward fails on GQA shards (its skipped half's
# zeros take dq's head count for dk and dv, flash_attention_tpu/parallel/
# ring.py:373-381, a broadcast error), so those gradients are held against
# jax.grad of its oracle.
ORACLE = {"full axis causal", "full axis zigzag", "grad zigzag gqa"}


def _inputs(name):
    """q, k, v and the loss weights of a case, U(-0.5, 0.5) fp32 from its seed."""
    _, hq, hkv, seq, *_ = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    shapes = [(1, hq, seq, D), (1, hkv, seq, D), (1, hkv, seq, D), (1, hq, seq, D)]
    return [rng.uniform(-0.5, 0.5, s).astype(np.float32) for s in shapes]


def _port_side() -> dict:
    """Every case on this rank (run by each of the WORLD ranks); rank 0's
    dict holds the gathered (out, dq, dk, dv) of each case."""
    from flash_attention_tpu_torch.parallel.mesh import gather, make_mesh, shard
    from flash_attention_tpu_torch.parallel.ring import make_ring_attention, ring_flash_attention

    torch.set_num_threads(1)
    out = {}
    for name, (mesh_shape, _, _, seq, causal, zigzag, grads) in CASES.items():
        mesh = make_mesh(*mesh_shape, device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        fn = make_ring_attention(mesh, causal=causal, zigzag=zigzag)
        q, k, v, w = (shard(torch.from_numpy(x), mesh, fn.out_spec) for x in _inputs(name))
        q, k, v = (x.requires_grad_(grads) for x in (q, k, v))
        o = fn(q, k, v)
        res = [o.detach()]
        if grads:
            (o * w).sum().backward()
            res += [q.grad, k.grad, v.grad]
        out[name] = [gather(x, mesh, fn.out_spec).numpy() for x in res]

    # The training loop's pattern: shards already in zigzag layout (permuted
    # once), ring_flash_attention called directly, gradients taken in that
    # layout and permuted back only here, for the comparison.
    mesh = make_mesh(1, 1, 4, device_type="cpu")
    if mesh.get_coordinate() is not None:
        spec = (None, None, "context", None)
        idx, _ = zigzag_data_layout(256, 4)
        q, k, v, w = (shard(torch.from_numpy(x)[:, :, idx], mesh, spec) for x in _inputs("grad zigzag gqa"))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ring_flash_attention(q, k, v, group=mesh.get_group("context"), causal=True, zigzag=True)
        (o * w).sum().backward()
        inv = inverse_permutation(idx)
        out["direct zigzag gqa"] = [gather(x, mesh, spec)[:, :, inv].numpy() for x in (o.detach(), q.grad, k.grad, v.grad)]

    # make_ring_attention's zigzag relayout, chunk by chunk, at context sizes
    # where a rank keeps one chunk, sends both, or sends both to one rank (3).
    from flash_attention_tpu_torch.parallel.ring import _relayout

    for n in RELAYOUT_SIZES:
        mesh = make_mesh(1, 1, n, device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        spec, group = (None, None, "context", None), mesh.get_group("context")
        local = shard(_relayout_input(n), mesh, spec)
        zig = _relayout(local, group, True)
        out[f"relayout {n}"] = [gather(x, mesh, spec).numpy() for x in (zig, _relayout(zig, group, False))]
    return out if torch.distributed.get_rank() == 0 else {}


RELAYOUT_SIZES = (2, 3, 4, 8)


def _relayout_input(n):
    """[1, 2, 2n x 3 rows, 4], every element distinct."""
    return torch.arange(2 * 2 * n * 3 * 4, dtype=torch.float32).reshape(1, 2, 2 * n * 3, 4)


@pytest.fixture(scope="module")
def port():
    return spawn_ranks(_port_side, WORLD, backend="gloo", timeout_s=300)[0]


def _jax_side(name):
    """The JAX package's ring (in interpret mode) at S <= 256, or its oracle
    (``ORACLE``), with jax.vjp for the gradient cases."""
    import jax
    import jax.numpy as jnp

    from flash_attention_tpu.ops.reference import reference_attention
    from flash_attention_tpu.parallel.mesh import make_mesh
    from flash_attention_tpu.parallel.ring import make_ring_attention

    mesh_shape, _, _, seq, causal, zigzag, grads = CASES[name]
    q, k, v, w = (jnp.asarray(x) for x in _inputs(name))
    if name in ORACLE:
        def fn(q, k, v):
            return reference_attention(q, k, v, causal=causal, out_dtype=jnp.float32)
    else:
        fn = make_ring_attention(make_mesh(*mesh_shape), causal=causal, zigzag=zigzag)
    if not grads:
        return [fn(q, k, v)]
    o, vjp = jax.vjp(fn, q, k, v)
    return [o, *vjp(w)]


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(port, name):
    for got, want, what in zip(port[name], _jax_side(name), ("out", "dq", "dk", "dv")):
        assert got.shape == want.shape
        assert np.abs(got - np.asarray(want)).max() <= TOL, f"{name}: {what}"


def test_ring_flash_attention_on_zigzag_shards_matches_jax(port):
    for got, want in zip(port["direct zigzag gqa"], _jax_side("grad zigzag gqa")):
        assert np.abs(got - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize("n", RELAYOUT_SIZES)
def test_zigzag_relayout_moves_chunks(port, n):
    """The relayout puts each rank's in-order rows where zigzag_indices
    lays them out, and its opposite move restores the in-order shards."""
    x = _relayout_input(n)
    zig, back = port[f"relayout {n}"]
    np.testing.assert_array_equal(zig, x[:, :, zigzag_indices(x.shape[2], n)].numpy())
    np.testing.assert_array_equal(back, x.numpy())


def test_zigzag_indices_roundtrip():
    from flash_attention_tpu.parallel.ring import zigzag_indices as jax_zigzag_indices

    idx = zigzag_indices(32, 4)
    # Shard 0 holds chunks {0, 7}, shard 1 {1, 6}, ...
    np.testing.assert_array_equal(idx[:8].numpy(), np.r_[0:4, 28:32])
    np.testing.assert_array_equal(idx[inverse_permutation(idx)].numpy(), np.arange(32))
    for seq, n in ((32, 4), (256, 4), (1024, 8), (16, 1)):
        np.testing.assert_array_equal(zigzag_indices(seq, n).numpy(), np.asarray(jax_zigzag_indices(seq, n)))
    idx, positions = zigzag_data_layout(64, 2)
    assert positions.dtype == torch.int32 and torch.equal(positions.long(), idx)
    with pytest.raises(ValueError, match="not divisible"):
        zigzag_indices(30, 4)
