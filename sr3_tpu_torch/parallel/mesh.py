"""The process mesh: data, model and space axes over ``torch.distributed``.

Counterpart of ``sr3_tpu/parallel/mesh.py`` (``create_mesh``,
``is_primary``, ``host_fetch``, ``shard_batch``) and of the multi-host start
in ``sr3_tpu/utils/runtime.py``. One process drives one device (a rank).
The ranks come from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); a config's
``"parallel": {"data": D, "model": M, "space": S}`` lays them out on a 3-D
``DeviceMesh`` with dims ("data", "model", "space"), row-major: rank =
(d * M + m) * S + s.

- data: each data coordinate takes its slice of the global batch; the
  gradients are averaged over the data group after the backward
  (``training/trainer.py``);
- model: conv / linear / GroupNorm parameters are sharded on their output
  channels (``parallel/sharding_rules.py``);
- space: activations are sharded on H (``parallel/spatial.py``).

D * M * S must equal WORLD_SIZE, and a ``parallel`` key of more than one
rank in a single process raises: a mesh is never dropped silently. With no
``parallel`` key (or all sizes 1) in one process, ``init_mesh`` returns None
and the port runs single-device as before. The backend is the caller's
choice (``--dist-backend``: nccl on CUDA, gloo on the CPU by default); the
package never swaps it. A rank's device is ``cuda:LOCAL_RANK``, or the
device the caller names (ranks that share one card, over gloo).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "space")


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's
    coordinate on it and the process group of the ranks that differ from
    this one only on it (None when the size is 1)."""

    name: str
    size: int
    rank: int
    group: Optional[object] = None

    def __deepcopy__(self, memo):  # process groups are not copyable
        return self


class Mesh:
    """This rank's view of the (data, model, space) mesh."""

    def __init__(self, shape, device, backend, device_mesh=None):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.device = torch.device(device)
        self.backend = backend
        if device_mesh is None:  # one process: every axis of size 1
            coords = (0, 0, 0)
            groups = (None, None, None)
        else:
            coords = tuple(device_mesh.get_coordinate())
            groups = tuple(device_mesh.get_group(a) if self.shape[a] > 1
                           else None for a in AXES)
        self.data, self.model, self.space = (
            Axis(a, self.shape[a], c, g)
            for a, c, g in zip(AXES, coords, groups))

    @property
    def coords(self):
        return self.data.rank, self.model.rank, self.space.rank

    @property
    def is_primary(self):
        return self.coords == (0, 0, 0)

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}"
                f", space={self.shape['space']}, coords={self.coords}, "
                f"backend={self.backend}, device={self.device})")


def parallel_shape(parallel):
    """{"data", "model", "space"} sizes of a config's ``parallel`` block
    (missing or null sizes are 1)."""
    parallel = dict(parallel or {})
    unknown = set(parallel) - set(AXES)
    if unknown:
        raise ValueError(f"parallel: unknown axes {sorted(unknown)}; the "
                         f"axes are {AXES}")
    shape = {a: int(parallel.get(a) or 1) for a in AXES}
    if min(shape.values()) < 1:
        raise ValueError(f"parallel: every axis size must be >= 1, got "
                         f"{shape}")
    return shape


def default_backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def init_mesh(parallel=None, backend=None, device=None):
    """The mesh of this process, or None for a single-device run.

    ``parallel``: the config's ``parallel`` block. ``backend``: the
    process group's backend (default nccl on CUDA, gloo on the CPU).
    ``device``: this rank's device (default: ``cuda:LOCAL_RANK``, or the CPU
    under ``SR3_PLATFORM=cpu``). Starts the default process group from
    torchrun's environment unless one is already running."""
    from torch.distributed.device_mesh import init_device_mesh

    from sr3_tpu_torch.utils.runtime import resolve_device

    shape = parallel_shape(parallel)
    want = int(np.prod(list(shape.values())))
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if want != world:
        raise ValueError(
            f"parallel {shape} needs {want} ranks (data * model * space) but "
            f"WORLD_SIZE is {world}; launch with torchrun --nproc_per_node "
            f"{want}, or change the config's parallel block")
    if world == 1:
        return None
    if device is None:
        device = resolve_device()
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or default_backend(device.type)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    elif dist.get_backend() != backend:
        raise ValueError(f"the running process group uses "
                         f"{dist.get_backend()}, not {backend}")
    # DeviceMesh's device type only places DTensors, which the port does
    # not use; "cpu" keeps it from binding ranks to cards itself (two ranks
    # may share one card over gloo)
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(shape[a] for a in AXES),
                          mesh_dim_names=AXES)
    return Mesh(shape, device, backend, dm)


def is_primary(mesh=None):
    """True on the rank that owns host-side writes (PNGs, metrics files,
    logs, TensorBoard / W&B streams, checkpoint files)."""
    return mesh is None or mesh.is_primary


def barrier(mesh):
    if mesh is not None:
        dist.barrier()


def all_gather_cat(x, axis, dim=0):
    """The tensors of every rank of ``axis`` concatenated along ``dim``, in
    rank order (every rank gets the whole). Identity for a size-1 axis."""
    if axis is None or axis.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def host_fetch(x, mesh, axis="data"):
    """``x`` (a numpy array or tensor of this rank's slice along dim 0)
    gathered from every rank of the mesh axis, as numpy, on every rank: the
    counterpart of ``process_allgather``. A collective: every rank of the
    axis calls it together."""
    if mesh is None or mesh.shape[axis] == 1:
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    out = all_gather_cat(t.to(mesh.device), getattr(mesh, axis))
    return out.cpu().numpy()


def data_slice(n, mesh):
    """The slice of a leading dim of ``n`` that this rank's data coordinate
    takes; all of it when the data axis does not divide n."""
    if mesh is None or mesh.data.size == 1 or n % mesh.data.size:
        return slice(0, n)
    per = n // mesh.data.size
    return slice(mesh.data.rank * per, (mesh.data.rank + 1) * per)


def shard_batch(batch, mesh):
    """This rank's data slice of a host batch dict (arrays along dim 0);
    a batch that the data axis does not divide is replicated, as the JAX
    package's ``shard_batch`` does. Other entries pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 or torch.is_tensor(v) \
                and v.dim() >= 1:
            out[k] = v[data_slice(v.shape[0], mesh)]
        else:
            out[k] = v
    return out


def data_mean(value, mesh):
    """The mean of a float over the data group (a collective)."""
    if mesh is None or mesh.data.size == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    if mesh.backend == "gloo" and t.device.type == "cuda":
        t = t.cpu()
    dist.all_reduce(t, group=mesh.data.group)
    return float(t.item()) / mesh.data.size


def start(args, parallel):
    """A driver's start on every rank: the mesh of the config's ``parallel``
    block (``init_mesh`` with ``args.dist_backend``), and on a mesh one
    experiment timestamp for all ranks (``args.timestamp``, the latest of
    the ranks' clocks), so that they name the same directories."""
    from sr3_tpu_torch.utils.config import get_timestamp

    mesh = init_mesh(parallel, backend=getattr(args, "dist_backend", None))
    if mesh is not None:
        t = torch.tensor([int(get_timestamp().replace("_", ""))],
                         dtype=torch.int64,
                         device=mesh.device if mesh.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        stamp = f"{int(t.item()):012d}"
        args.timestamp = stamp[:6] + "_" + stamp[6:]
    return mesh


def add_dist_argument(parser):
    parser.add_argument(
        "--dist-backend", dest="dist_backend", default=None,
        help="torch.distributed backend of a run under torchrun with a "
             "config 'parallel' block (default: nccl on CUDA, gloo on the "
             "CPU)")


def finish(mesh):
    """End a driver's run on every rank: a barrier, then the process
    group's end."""
    if mesh is not None and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
