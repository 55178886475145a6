"""Process mesh and batch sharding (the port of `geovpr.parallel.mesh`).

JAX runs one controller over a global array, and XLA inserts the
collectives from the arrays' shardings (`geovpr/parallel/mesh.py:1-10`).
The port runs one process per card over `torch.distributed`: NCCL for CUDA
tensors, gloo for CPU tensors, chosen by the device, never one in place of
the other. A `Mesh` lays the ranks of the default process group out
row-major in its shape, exactly as `create_mesh` places JAX's devices
(`np.asarray(devices).reshape(mesh_shape)`), and holds one sub-group per
axis line, so a collective over `data` or `model` reaches just the ranks
that share the other coordinates. Where JAX hands the host a global array,
every rank of the port ends up holding the same tensor, by `all_gather` or
`all_reduce` (`gather_rows`, `all_reduce_`); only rank 0 writes files
(`is_writer`), the others wait at a barrier.

Without a process group there is no mesh: every entry point takes
`mesh=None` and then runs its single-process path, with no collective.

`batch_sharding` and `replicated_sharding` have no counterpart: a rank
holds its rows of a batch as a plain tensor (`shard_batch`), and whatever
is replicated is a plain tensor on every rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """The ranks of the default process group in a named, row-major grid
    (`jax.sharding.Mesh`'s counterpart). `devices` holds the rank ids in
    the mesh's shape, `shape` maps each axis name to its size, `coords`
    this rank's position; `group(axis)` is the process group of this
    rank's line along `axis`. Build it with `create_mesh` or
    `create_hybrid_mesh`, on every rank alike (the sub-groups are made
    collectively)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not once in the mesh "
                             f"{self.devices.tolist()}")
        self.coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self._groups = {}
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(
                -1, self.devices.shape[i])
            for line in lines:     # every rank makes every group, in order
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = group

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis] if axis in self.coords else 0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def __repr__(self):
        return f"Mesh(shape={self.shape}, rank={self.rank})"


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data",),
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks of the default group (`devices`: the rank ids
    to lay out, all by default). Defaults to a 1-D data-parallel mesh; for
    DP x TP pass e.g. ``mesh_shape=(2, 2), axis_names=("data",
    "model")``."""
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    if mesh_shape is None:
        mesh_shape = (len(devices),)
    if int(np.prod(mesh_shape)) != len(devices):
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)} does not cover {len(devices)} "
            f"devices")
    if len(mesh_shape) != len(axis_names):
        raise ValueError("mesh_shape and axis_names must have the same rank")
    return Mesh(np.asarray(devices).reshape(mesh_shape), axis_names)


def hybrid_layout(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                  devices: Sequence[int], local_size: int) -> np.ndarray:
    """The rank ids of a DCN x ICI mesh: axis i spans dcn_shape[i] hosts
    times ici_shape[i] ranks of one host, the host factor outer, as
    `mesh_utils.create_hybrid_device_mesh` lays them. Ranks are
    host-major (`torchrun` numbers rank = host * local_size + local), so
    each host's ranks fill one ICI block. One host: the contiguous
    reshape (`geovpr/parallel/mesh.py:94-103`)."""
    ici, dcn = tuple(ici_shape), tuple(dcn_shape)
    total = tuple(i * d for i, d in zip(ici, dcn))
    devices = np.asarray(list(devices))
    if local_size >= devices.size:
        return devices.reshape(total)
    if int(np.prod(ici)) != local_size:
        raise ValueError(f"hybrid mesh: ici_shape {ici} does not cover the "
                         f"{local_size} ranks of one host")
    out = np.empty(total, devices.dtype)
    for coord in np.ndindex(*total):
        host = np.ravel_multi_index([c // i for c, i in zip(coord, ici)],
                                    dcn)
        local = np.ravel_multi_index([c % i for c, i in zip(coord, ici)],
                                     ici)
        out[coord] = devices[host * local_size + local]
    return out


def create_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                       axis_names: Sequence[str],
                       devices: Optional[Sequence[int]] = None,
                       local_size: Optional[int] = None) -> Mesh:
    """Hierarchical DCN x ICI mesh for multi-host fleets
    (`geovpr.parallel.create_hybrid_mesh`): `ici_shape` and `dcn_shape`
    are per-axis factors of the same rank, and an axis with dcn_shape > 1
    crosses hosts, so lay the heavy collectives (the TP gathers) on axes
    that stay inside one host. `local_size` is the number of ranks a host
    runs (`LOCAL_WORLD_SIZE`, as torchrun sets it; the whole world when
    unset)."""
    ici_shape, dcn_shape = tuple(ici_shape), tuple(dcn_shape)
    if len(ici_shape) != len(dcn_shape) or len(ici_shape) != len(axis_names):
        raise ValueError("ici_shape, dcn_shape, and axis_names must have "
                         "the same rank")
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    total = tuple(i * d for i, d in zip(ici_shape, dcn_shape))
    if int(np.prod(total)) != len(devices):
        raise ValueError(f"hybrid mesh {total} (ici {ici_shape} x dcn "
                         f"{dcn_shape}) does not cover {len(devices)} devices")
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", len(devices)))
    return Mesh(hybrid_layout(ici_shape, dcn_shape, devices, local_size),
                axis_names)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Opt-in multi-process bring-up (`jax.distributed.initialize`'s
    counterpart): `init_process_group` once per process, then this rank's
    device, `cuda:{local rank}` (made current) or the CPU. Arguments left
    None come from torchrun's environment (`MASTER_ADDR`/`MASTER_PORT`,
    `WORLD_SIZE`, `RANK`, `LOCAL_RANK`), the port's counterpart of JAX's
    auto-detection on pods. `coordinator_address` is host:port (a
    `tcp://` rendezvous) or a full init method (`file://...`). The
    backend is NCCL for a CUDA device and gloo for the CPU unless given."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = (num_processes if num_processes is not None
                     else _env_int("WORLD_SIZE"))
    process_id = (process_id if process_id is not None
                  else _env_int("RANK"))
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator "
                         "address, the process count and this process's "
                         "id (arguments, or torchrun's environment)")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    if device.type != "cuda":
        return device
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = process_id % max(torch.cuda.device_count(), 1)
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files: always without a mesh,
    rank 0 under one."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank waits here (the others for rank 0's writes)."""
    if mesh is not None:
        dist.barrier()


def shard_rows(mesh: Mesh, n: int, axis: str = "data") -> slice:
    """This rank's rows of an n-row batch split evenly over `axis`."""
    per = n // mesh.axis_size(axis)
    start = mesh.index(axis) * per
    return slice(start, start + per)


def shard_batch(mesh: Mesh, batch: dict, axis: str = "data") -> dict:
    """This rank's rows (dim 0) of every array of a host batch, as tensors
    (`shard_batch`'s counterpart: JAX device_puts the global batch with
    dim 0 sharded over `axis`; `prefetch_to_device(mesh=...)` does this on
    the way to the device). Rows must divide the axis
    (`pad_batch_to_multiple` first); keys starting with "_" (host
    metadata) pass through."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            out[k] = v
            continue
        rows = shard_rows(mesh, v.shape[0], axis)
        out[k] = v[rows] if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v[rows]))
    return out


def pad_batch_to_multiple(batch: dict, multiple: int) -> tuple:
    """Pad dim 0 of every array to a multiple of `multiple` by repeating
    row 0, returning (padded batch, valid mask) (`geovpr/parallel/
    mesh.py:131-149`): the padded rows keep the compute finite and the
    mask keeps them out of losses and metrics. numpy on the host."""
    n = next(iter(batch.values())).shape[0]
    padded_n = -(-n // multiple) * multiple
    pad = padded_n - n

    def _pad(x):
        if pad == 0:
            return x
        fill = np.repeat(np.asarray(x[:1]), pad, axis=0)
        return np.concatenate([np.asarray(x), fill], axis=0)

    mask = np.arange(padded_n) < n
    return {k: _pad(v) for k, v in batch.items()}, mask


# ------------------------------------------------------------ collectives --

def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str = "data",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `axis` (f32 and integer tensors:
    gloo reduces no bf16)."""
    dist.all_reduce(t, op=op, group=mesh.group(axis))
    return t


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
    """Every rank's `t` along `axis`, concatenated along `dim` in the
    axis's order. bf16 travels widened to f32 (exact both ways; gloo does
    not carry bf16 in every torch release, nor int16)."""
    n = mesh.axis_size(axis)
    wire = t.contiguous()
    if wire.dtype == torch.bfloat16:
        wire = wire.float()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=mesh.group(axis))
    return torch.cat(parts, dim=dim).to(t.dtype)


def gather_rows(t: torch.Tensor, mesh: Mesh,
                axis: str = "data") -> torch.Tensor:
    """The global batch from each rank's rows: JAX's view of a
    batch-sharded output, on every rank."""
    return all_gather_cat(t, mesh, axis, 0)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, with the gradient summed over it too: a global
    sum whose inputs every rank holds a part of."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum_autograd(t: torch.Tensor, mesh: Mesh,
                            axis: str = "data") -> torch.Tensor:
    """`all_reduce_` under autograd (BatchNorm's global statistics)."""
    return _AllReduceSum.apply(t, mesh.group(axis))


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's `obj` on every rank (a picklable host value, such as a
    run directory's name)."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
