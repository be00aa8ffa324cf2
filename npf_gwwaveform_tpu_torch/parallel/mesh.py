"""Device mesh for data- and sequence-parallel training, the counterpart of
`npf_gwwaveform_tpu/parallel/mesh.py`.

One process is one rank of a `torch.distributed` group: NCCL on CUDA (each
rank on the GPU `LOCAL_RANK` names, or rank modulo the GPU count), gloo on
the CPU, or whatever backend the caller initialised the default group with
(two ranks sharing one GPU need gloo: NCCL refuses them). A mesh arranges
the ranks row-major on named axes, as JAX reshapes its devices: rank = the
coordinates' row-major index. Each axis has a process group per fibre (the
ranks that differ only on that axis).

The `data` axis splits the batch's rows: `shard_batch` gives each rank its
block of the leading dimension. The `seq` axis splits the targets of the
long-waveform regime: every rank of a `seq` group holds the whole batch,
contexts and targets alike, encodes all of it, and decodes only its slice of
the targets (`seq_shard`: the model cuts the target inputs, the loss the
target values), the slice that JAX's P('data', 'seq') gives a device;
`constrain_targets_seq` cuts a batch's targets to it, as JAX's does. The reductions that JAX's global program
makes across devices for free are made explicitly
(`parallel.collectives`): BatchNorm's statistics over the `data` group, the
target sum over the `seq` group, and the gradients over every rank
(`training.Trainer`).

The modules find the mesh of the step they run in through `use_mesh`, a
context the Trainer enters around its forward and backward: without one
(`active_mesh()` None) every module computes as it does on one process.

JAX's `batch_sharding` and `replicated_sharding` have no counterpart: a rank
holds its rows as plain tensors and a full replica of every parameter.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "SEQ_AXIS", "Mesh", "make_mesh", "shard_batch", "has_seq_axis",
           "seq_shard", "constrain_targets_seq", "use_mesh", "active_mesh"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"

# target-side batch keys whose 2nd dim is the (padded) target/time axis
_TARGET_KEYS = ("X_trgt", "Y_trgt", "mask_trgt")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("npf_mesh", default=None)


@dataclass(frozen=True)
class Mesh:
    """The ranks on named axes: `shape` [n_axis], this rank's `coords`, the
    process group of this rank's fibre along each axis (`groups`), the
    default group's `backend` and the rank's `device`."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    groups: dict
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, name: str) -> int:
        """The axis' length, 1 for an axis the mesh does not have."""
        return self.shape[self.axis_names.index(name)] if name in self.axis_names else 1

    def axis_rank(self, name: str) -> int:
        """This rank's coordinate on the axis, 0 for one it does not have."""
        return self.coords[self.axis_names.index(name)] if name in self.axis_names else 0

    def group(self, name: str):
        """This rank's process group along the axis (None: the axis is absent)."""
        return self.groups.get(name)


def _local_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): no CUDA device (pass device='cpu' for gloo "
                           "ranks on the CPU)")
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def make_mesh(axes: Optional[Dict[str, int]] = None, device="cuda") -> Mesh:
    """A mesh over every rank of the default process group. `axes` maps
    axis name -> size; a single -1 axis takes the ranks the others leave,
    and the sizes' product must be the world size. Default: one `data` axis
    over every rank.

    Initialises the default group from the environment (`env://`, as
    `python -m torch.distributed.run` sets it) where the caller has not:
    NCCL for `device="cuda"`, gloo for "cpu". On CUDA it sets this rank's
    device and, with NCCL, makes each group's communicator with one
    all-reduce, before any step is captured in a CUDA graph."""
    device = torch.device(device)
    if not dist.is_initialized():
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if device.type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU mesh needs the gloo backend, not {backend}")
    device = _local_device(device, rank)
    if axes is None:
        axes = {DATA_AXIS: -1}
    names, sizes = tuple(axes), list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axes}: at most one axis of size -1")
    fixed = int(np.prod([s for s in sizes if s != -1]))
    sizes = tuple(world // fixed if s == -1 else int(s) for s in sizes)
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {world} ranks")
    grid = np.arange(world).reshape(sizes)
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    groups = {}
    for i, name in enumerate(names):  # every rank makes every group, in the same order
        for fibre in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            g = dist.new_group([int(r) for r in fibre])
            if rank in fibre:
                groups[name] = g
    mesh = Mesh(names, sizes, coords, groups, backend, device)
    if backend == "nccl":
        for g in groups.values():
            dist.all_reduce(torch.zeros(1, device=device), group=g)
        torch.cuda.synchronize(device)
    return mesh


def _rows(t, mesh: Mesh):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _rows(v, mesh) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_rows(v, mesh) for v in t)
    d, r = mesh.axis_size(DATA_AXIS), mesh.axis_rank(DATA_AXIS)
    if t.shape[0] % d:
        raise ValueError(f"a batch of {t.shape[0]} rows does not divide over the data axis' {d} "
                         "ranks")
    n = t.shape[0] // d
    return t[r * n:(r + 1) * n]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of the leading dimension of every tensor in a
    (nested dict, tuple or list) batch: the r-th of the data axis' d equal
    blocks. A batch that d does not divide is refused (ValueError), as
    JAX's jit with batch-sharded `in_shardings` refuses it."""
    return _rows(batch, mesh)


def has_seq_axis(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and SEQ_AXIS in mesh.axis_names


def seq_shard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of dim 1 over the seq axis, contiguous (the kernel
    wrappers take contiguous inputs only). `tensor_split`'s slices, so that
    a count the axis does not divide still splits (the first slices one
    longer; GSPMD pads the last one instead, a split of the same sum)."""
    return t.tensor_split(mesh.axis_size(SEQ_AXIS), dim=1)[mesh.axis_rank(SEQ_AXIS)].contiguous()


def constrain_targets_seq(batch: dict, mesh: Optional[Mesh]) -> dict:
    """The batch with `X_trgt`, `Y_trgt` and `mask_trgt` cut to this rank's
    slice of the targets (`seq_shard`); the batch itself for a mesh without
    a seq axis."""
    if not has_seq_axis(mesh):
        return batch
    out = dict(batch)
    for k in _TARGET_KEYS:
        if out.get(k) is not None:
            out[k] = seq_shard(out[k], mesh)
    return out


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Within the block `active_mesh()` is `mesh` (None: one process)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the step being run (`use_mesh`), or None."""
    return _ACTIVE.get()
