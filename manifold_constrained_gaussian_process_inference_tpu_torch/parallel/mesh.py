"""The port's device mesh over ``torch.distributed`` (the counterpart of the
JAX package's ``jax.sharding.Mesh`` with ``lax.psum``/``pmean``).

The JAX package is single-controller: one process drives every device of a
1-D ``Mesh``, and ``shard_map`` gives each device a block of the sharded
axis. In the port each rank is a process of its own: it holds one block of
the sharded axis (NUTS chains, PT replica ladders or the time grid) on its
device, and every cross-block reduction is a collective over the process
group. A ``Mesh`` is the rank's view of that group: its rank, the group's
size, the axis name and the device its tensors live on.

The port creates no process group. Callers start the ranks (``torchrun``,
or ``torch.multiprocessing`` as ``parallel/dryrun.run_ranks`` does for the
tests and the smoke) and call ``torch.distributed.init_process_group``
before making a Mesh. The backend is the caller's: NCCL for ranks on
different cards; gloo on the CPU, or for ranks that share one card (NCCL
refuses two ranks on one card). The helpers use ``all_reduce``,
``broadcast`` and ``all_gather`` only, which both backends take on CUDA
tensors (gloo copies them through the host itself). A host value (an int,
a numpy array) travels on the CPU under gloo and on the rank's device under
NCCL, which takes device tensors only.

Every rank's result of a collective is the same, bit for bit, so values
reduced here (pooled moments, swap counters, adaptation statistics) drive
the same decisions on every rank. A mesh of one rank runs the same
collectives, each the identity.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import default_device

CHAIN_AXIS = "chains"
REPLICA_AXIS = "replicas"
GRID_AXIS = "grid"


class Mesh:
    """A 1-D mesh of the ranks of ``group`` (the default process group when
    None) along ``axis_name``. ``device``: where the rank's tensors live
    (None = ``default_device()``; ranks that share a card all use it)."""

    def __init__(self, axis_name: str, device=None, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a Mesh needs an initialized torch.distributed process group: start the "
                "ranks with torchrun or torch.multiprocessing and call "
                "torch.distributed.init_process_group first."
            )
        self.axis_name = axis_name
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device) if device is not None else default_device()
        # NCCL reduces device tensors only; gloo takes host values where they are
        self.host_device = self.device if self.backend == "nccl" else torch.device("cpu")
        self._root = 0 if group is None else dist.get_global_rank(group, 0)

    @classmethod
    def world(cls, axis_name: str, n_devices: Optional[int] = None, device=None) -> "Mesh":
        """A mesh along ``axis_name`` over every rank of the initialized
        default process group (``n_devices``, when given, must be their
        number)."""
        mesh = cls(axis_name, device=device)
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"n_devices={n_devices}, but the process group has {mesh.size} ranks")
        return mesh

    @property
    def axis_names(self):
        return (self.axis_name,)

    def __repr__(self):
        return (f"Mesh({self.axis_name!r}, rank {self.rank} of {self.size}, {self.backend}, "
                f"{self.device})")

    # -- blocks of a sharded axis ---------------------------------------------

    def check_divides(self, n: int, what: str) -> None:
        """The JAX package's error for an axis that does not split evenly."""
        if n % self.size:
            raise ValueError(f"{what}={n} must be a multiple of mesh size {self.size}")

    def block(self, n: int) -> slice:
        """This rank's block of an axis of length ``n`` (a multiple of size)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- collectives on tensors of the rank's device ---------------------------

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks: exact for the block means of
        equal blocks."""
        return self.psum(t) / self.size

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks of ``t`` concatenated along ``dim`` in rank
        order (every block has t's shape)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's values of ``t`` (contiguous), written into ``t`` on every
        rank."""
        if not t.is_contiguous():
            raise ValueError("broadcast_ needs a contiguous tensor: the ranks' layouts must agree")
        dist.broadcast(t, src=self._root, group=self.group)
        return t

    def barrier(self) -> None:
        """Wait until every rank of the mesh is here."""
        dist.barrier(group=self.group)

    # -- host values -----------------------------------------------------------

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` (tensors keep their values bit for bit
        and come back on the device they left); the others pass anything."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._root, group=self.group,
                                   device=self.host_device)
        return box[0]

    def max_int(self, value: int) -> int:
        """The largest of the ranks' host ints."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.host_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t.item())

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        # bool travels as uint8 (one byte either way)
        a = a.view(np.uint8) if a.dtype == np.bool_ else a
        return torch.as_tensor(a, device=self.host_device)

    def gather_np(self, a: np.ndarray, axis: int = 0) -> np.ndarray:
        """The ranks' blocks of the host array ``a`` concatenated along
        ``axis`` in rank order."""
        a = np.asarray(a)
        out = self.all_gather(self._host_tensor(a), dim=axis).cpu().numpy()
        return out.view(np.bool_) if a.dtype == np.bool_ else out

    def broadcast_np(self, a: np.ndarray) -> np.ndarray:
        """Rank 0's host array (every rank passes one of its shape and dtype)."""
        t = self._host_tensor(np.array(a))
        return self.broadcast_(t).cpu().numpy()


def local_draw(sample: Callable, generator: torch.Generator, shape: Sequence[int], axis: int,
               mesh: Optional[Mesh], dtype, device) -> torch.Tensor:
    """``sample(shape)`` (``torch.rand`` or ``torch.randn``) where
    ``shape[axis]`` is the chain axis of this rank's block. Under a mesh
    every rank draws the whole axis from its generator (seeded alike on
    every rank) and keeps its block, so a chain's numbers do not depend on
    how the chains are sharded, and the generators stay in step."""
    if mesh is None:
        return sample(tuple(shape), generator=generator, dtype=dtype, device=device)
    full = list(shape)
    full[axis] *= mesh.size
    out = sample(tuple(full), generator=generator, dtype=dtype, device=device)
    return out.narrow(axis, mesh.rank * shape[axis], shape[axis])


def gather_rows(mesh: Optional[Mesh], a, axis: int = 0):
    """``a`` (a tensor or a host array) with the ranks' blocks along
    ``axis`` gathered; ``a`` itself without a mesh."""
    if mesh is None:
        return a
    if isinstance(a, torch.Tensor):
        return mesh.all_gather(a, dim=axis)
    return mesh.gather_np(a, axis=axis)


def broadcast_tensors(mesh: Optional[Mesh], tensors):
    """Rank 0's values of each tensor of a named tuple (copies); the tuple
    itself without a mesh."""
    if mesh is None:
        return tensors
    return type(tensors)(*(mesh.broadcast_(t.clone(memory_format=torch.contiguous_format))
                           for t in tensors))
