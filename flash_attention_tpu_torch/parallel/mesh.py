"""The device mesh, its collectives, and the shard / gather helpers.

Counterpart of the JAX package's ``parallel/mesh.py`` on
``torch.distributed``. Axis convention (used across the package):
  "data"    — batch / data parallelism (no communication during attention)
  "model"   — tensor parallelism over attention heads
  "context" — sequence parallelism over the KV axis (ring attention)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those three
dimension names over the first data x model x context ranks of the default
process group; each dimension's process group (``mesh.get_group(name)``)
carries that axis's collectives. A rank outside the mesh has no coordinate
and takes no part.

The collectives here are the only ones the parallel layer runs, and they
take the card's tensors as they are, with one exception. Over gloo (the
CPU tests, and several ranks sharing one card, which NCCL refuses),
all_reduce and all_gather carry CUDA tensors, but a send or receive of one
aborts the process (torch's gloo transport writes from the device pointer;
found on an H100 with ``tools/smoke_cases.py . gloo_cuda``). So every
point-to-point transfer (``Exchange``: the ring's rotation, the zigzag
relayout) stages CUDA tensors through pinned host buffers when the group's
backend is gloo (``host_staged``): the choice is made from the backend,
never from a caught error.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from flash_attention_tpu_torch.ops.quant import QuantizedTensor

AXES = ("data", "model", "context")


def make_mesh(data: int = 1, model: int = 1, context: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """A (data, model, context) mesh over the first data x model x context
    ranks of the initialised default process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (initialize_distributed)")
    n, world = data * model * context, dist.get_world_size()
    if n > world:
        raise ValueError(f"need {n} processes, have {world}")
    return init_device_mesh(device_type, (data, model, context), mesh_dim_names=AXES)


def auto_mesh(n_devices: int | None = None, *, num_kv_heads: int = 8, device_type: str = "cuda") -> DeviceMesh:
    """Default serving mesh: shard heads up to num_kv_heads, rest on data.

    GQA co-location rule (q heads stay with their KV head): the model axis
    never exceeds the KV head count.
    """
    if n_devices is None:
        n_devices = dist.get_world_size()
    model = math.gcd(n_devices, num_kv_heads)
    return make_mesh(data=n_devices // model, model=model, device_type=device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along ``name``; raises outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return coord[mesh.mesh_dim_names.index(name)]


# ---------------------------------------------------------------- collectives


def host_staged(group, t: torch.Tensor) -> bool:
    """Whether an ``Exchange`` on ``group`` moves ``t`` through a pinned
    host buffer: a CUDA tensor over gloo, whose sends take host memory only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_(t: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` of a contiguous ``t`` in place over ``group``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` over ``group``, concatenated along ``dim`` in the
    group's rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def barrier(mesh: DeviceMesh) -> None:
    """Return once every rank of ``mesh`` has called it: an all-reduce over
    each axis's group in turn, each waited on (a rank passes the last one
    only after every rank of the mesh has entered the first)."""
    for name in AXES:
        group = mesh.get_group(name)
        flag = torch.zeros(1, device="cpu" if dist.get_backend(group) == "gloo" else mesh.device_type)
        dist.all_reduce(flag, group=group)
        flag.cpu()


class Exchange:
    """Point-to-point transfers over ``group``, all posted at once
    (``dist.batch_isend_irecv``) so they overlap whatever runs before
    ``wait``. ``sends`` are (tensor, group rank, tag), ``recvs`` (tensor of
    the shape and dtype to receive, group rank, tag); a send matches the
    receive of the same tag on its peer, so transfers in flight together
    between two ranks use distinct tags, each pair posted in one order on
    both sides."""

    def __init__(self, sends, recvs, group):
        ranks = dist.get_process_group_ranks(group)
        self.staged = [host_staged(group, t) for t, _, _ in recvs]
        self._device = [t.device for t, _, _ in recvs]
        self._send = [_to_host(t) if host_staged(group, t) else t.contiguous() for t, _, _ in sends]
        self._recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if s else
                      torch.empty(t.shape, dtype=t.dtype, device=t.device) for (t, _, _), s in zip(recvs, self.staged)]
        ops = [dist.P2POp(dist.isend, t, ranks[r], group, tag=tag) for t, (_, r, tag) in zip(self._send, sends)]
        ops += [dist.P2POp(dist.irecv, t, ranks[r], group, tag=tag) for t, (_, r, tag) in zip(self._recv, recvs)]
        self._works = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> list[torch.Tensor]:
        """The received tensors, in ``recvs``' order, on the devices their
        templates were on."""
        for w in self._works:
            w.wait()
        return [t.to(d) if s else t for t, s, d in zip(self._recv, self.staged, self._device)]


class Rotation(Exchange):
    """One hop of a ring: each rank sends its tensors to the next rank of
    ``group`` and receives the previous rank's. Tensor i travels under tag
    ``tag + i``, so rotations in flight together must use disjoint tags."""

    def __init__(self, tensors, group, tag: int = 0):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        super().__init__([(t, (me + 1) % n, tag + i) for i, t in enumerate(tensors)],
                         [(t, (me - 1) % n, tag + i) for i, t in enumerate(tensors)], group)


def rotate(tensors, group, tag: int = 0) -> list[torch.Tensor]:
    """One blocking hop of a ring (``Rotation``)."""
    return Rotation(tensors, group, tag).wait()


# ---------------------------------------------------------------- shard / gather


def shard(x, mesh: DeviceMesh, spec):
    """This rank's block of the global tensor ``x`` (a QuantizedTensor: its
    payload and scales alike): dimension i is split evenly over the mesh axis
    ``spec[i]`` (None: kept whole), as a ``PartitionSpec`` places it."""
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(shard(x.values, mesh, spec), shard(x.scales, mesh, spec))
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n, size = axis_size(mesh, name), x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over the {n} ranks of {name!r}")
        x = x.narrow(dim, axis_index(mesh, name) * (size // n), size // n)
    return x.contiguous()


def gather(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """The global tensor from every rank's ``shard`` of it (each rank gets
    the whole)."""
    for dim, name in reversed(list(enumerate(spec))):
        if name is not None:
            x = all_gather(x, dim, mesh.get_group(name))
    return x
