"""Data-parallel ranks over ``torch.distributed``
(``causalvae_tpu/parallel/mesh.py``).

The JAX package's data parallelism is a 1-D mesh of devices: the batch's
leading dim sharded over it, parameters and optimizer state replicated, and
the ordinary jitted step, whose reductions GSPMD turns into collectives
(the result is the one-device step on the whole batch). Here a rank is one
process with one device, in one process group:

- ``make_mesh`` joins (or starts) the group and returns the ``Mesh``: this
  rank, the number of ranks, its device and the group;
- ``shard_batch`` takes this rank's contiguous rows of every leaf of a
  batch, ``replicate`` broadcasts rank 0's parameters and buffers,
  ``pad_to_multiple`` pads a batch to a multiple of the ranks with zeros,
  ``stack_params`` stacks members' state dicts along a new leading axis;
- ``global_batch`` marks the block in which a step on this rank's rows is
  to compute what the one-process step computes on the whole batch
  (``train/loop.py make_vae_step(mesh=...)``): while it is open,
  ``current_global_batch`` tells the BatchNorms (the kernels' and
  ``models.mechanism.PlainBatchNorm``) to reduce their sums across the
  ranks, the vessel loss to take the whole batch's ``pos_weight``, and
  the random draws that are per sample (the reparameterisation noise,
  ``nn.Dropout``'s masks, the attention-dropout hash's heads) to take this
  rank's rows of the whole batch's draws.

Backends: NCCL for CUDA, gloo for the CPU. NCCL takes one card per rank and
refuses two ranks on one card ("Duplicate GPU detected"); ranks that share
a card must ask for ``backend="gloo"``, which reduces CUDA tensors through
the host. ``make_mesh`` raises rather than switch backends by itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from causalvae_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D data-parallel group."""

    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None  # a torch.distributed ProcessGroup; None: the default
    axis: str = DATA_AXIS

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tree is laid over the mesh: ``"batch"`` (the leading dim split
    over ``axis``) or ``"replicated"`` (whole on every rank)."""

    kind: str
    axis: Optional[str]
    size: int


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(device: DeviceLike, local_rank: int) -> torch.device:
    if device is None or torch.device(device) == torch.device("cuda"):
        if torch.cuda.is_available() and local_rank >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local_rank} has no card of its own "
                             f"({torch.cuda.device_count()} visible); pass the device")
        return resolve_device(f"cuda:{local_rank}")
    return resolve_device(device)


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS,
              backend: Optional[str] = None, device: DeviceLike = None) -> Mesh:
    """This rank's ``Mesh``. An initialised default group is taken as it is;
    otherwise one is started from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or, with none of it, as a group of one on a free
    local port. The device is ``cuda:{LOCAL_RANK}`` unless ``device`` says
    otherwise (``"cpu"``); the backend NCCL for a CUDA device, gloo for the
    CPU, unless ``backend`` says otherwise. ``n_devices``, where given, must
    be the group's size."""
    env = os.environ
    local = int(env.get("LOCAL_RANK", env.get("RANK", 0)))
    dev = _device(device, local)
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"the default group runs {dist.get_backend()}, not {backend}")
        backend = dist.get_backend()
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL reduces CUDA tensors; the device is {dev}")
        if dev.index != local:
            raise ValueError(
                f"NCCL takes one card per rank (it refuses two ranks on one card: "
                f"'Duplicate GPU detected'); this rank ({local}) is on {dev}: ranks "
                "that share a card need backend='gloo'")
    if not dist.is_initialized():
        if "RANK" in env and "WORLD_SIZE" in env:
            dist.init_process_group(backend, init_method="env://")
        elif n_devices in (None, 1):
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                    rank=0, world_size=1)
        else:
            raise ValueError(f"a mesh of {n_devices} ranks needs RANK, WORLD_SIZE and "
                             "MASTER_ADDR/MASTER_PORT (torchrun sets them)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the group has {size} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.get_rank(), size, dev, None, axis)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) dimension split across the mesh's axis."""
    return Sharding("batch", mesh.axis, mesh.size)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding("replicated", None, mesh.size)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous rows of every leaf (array or tensor) of a
    batch tree, as tensors on its device: rows [rank·n/size,
    (rank+1)·n/size). A leading dim that is not a multiple of the ranks
    raises (``pad_to_multiple`` first)."""

    def take(leaf):
        t = torch.as_tensor(leaf)
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"leading dim {n} is not a multiple of the mesh's "
                             f"{mesh.size} ranks; pad_to_multiple(batch, {mesh.size}) first")
        per = n // mesh.size
        return t[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)

    return _tree_map(take, batch)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The module on this rank's device with rank 0's parameters and
    buffers (broadcast in place); returns it."""
    module.to(mesh.device)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def pad_to_multiple(batch: Any, multiple: int) -> Any:
    """Every leaf's leading dim padded with zeros up to a multiple of
    ``multiple`` (static shapes on every rank)."""

    def pad(x):
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))

    return _tree_map(pad, batch)


def stack_params(state_dicts: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Members' state dicts stacked along a new leading axis (the fold or
    ensemble axis of the JAX package's vmapped members)."""
    return {k: torch.stack([sd[k] for sd in state_dicts]) for k in state_dicts[0]}


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place (gloo and NCCL alike); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


class _SumOverRanks(torch.autograd.Function):
    """Σ over the ranks of a tensor; every rank's loss reads that sum, so the
    gradient of each rank's copy is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.mesh), None


def sum_over_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor), differentiable: its
    backward sums the incoming gradient over the ranks too."""
    return _SumOverRanks.apply(t, mesh)


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """The rows [start, start + rows) of a batch of ``total`` rows held by
    this rank of ``mesh``."""

    mesh: Mesh
    start: int
    rows: int
    total: int

    def take(self, draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]
             ) -> torch.Tensor:
        """This rank's rows of ``draw`` of the whole batch's shape (``shape``
        with its leading dim the local rows)."""
        return draw((self.total,) + tuple(shape[1:]))[self.start:self.start + self.rows]


_CURRENT: Optional[GlobalBatch] = None


def current_global_batch() -> Optional[GlobalBatch]:
    """The ``global_batch`` block open on this process, or None."""
    return _CURRENT


@contextlib.contextmanager
def global_batch(mesh: Mesh, rows: int) -> Iterator[GlobalBatch]:
    """Within the block, this rank's ``rows`` rows (every rank the same
    number) are rows [rank·rows, (rank+1)·rows) of the whole batch. Kept in
    a module variable, not per thread: CUDA's autograd runs the backward in
    a thread of its own."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("a global_batch block is already open")
    _CURRENT = GlobalBatch(mesh, mesh.rank * rows, rows, mesh.size * rows)
    try:
        yield _CURRENT
    finally:
        _CURRENT = None
