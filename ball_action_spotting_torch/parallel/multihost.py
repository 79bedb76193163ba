"""Training over several processes, one per device (port of the JAX
package's ``parallel/multihost.py``), over ``torch.distributed``.

JAX runs one program over a global mesh and feeds each process's rows into
it; the port runs the same train step in every process on its own rows and
joins them with collectives: the BatchNorm statistics of the global batch
(``models/effnetv2.py::BatchNormAct``), the augmented batch before mixup,
and the averaged gradients (``train/steps.py``). Launch with ``torchrun``::

    torchrun --nproc_per_node 4 -m ball_action_spotting_torch.train --experiment NAME

``initialize`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or takes an
``init_method`` such as ``tcp://localhost:29500`` with ``world_size`` and
``rank``. NCCL joins CUDA devices and gloo the CPU; host-side gathers
(batch counts, validation outputs) go over a gloo group of their own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = None


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    index: int
    count: int

    @property
    def is_primary(self) -> bool:
        return self.index == 0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: float = 600.0) -> ProcessInfo:
    """Join (or start) the process group; idempotent.

    Without arguments it reads torchrun's environment. ``backend`` defaults
    to NCCL where CUDA is available (each process then takes
    ``cuda:LOCAL_RANK``), else gloo."""
    global _HOST_GROUP
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
        kwargs = {"timeout": datetime.timedelta(seconds=timeout_s)}
        if init_method is not None:
            kwargs.update(init_method=init_method, world_size=world_size, rank=rank)
        dist.init_process_group(backend, **kwargs)
        _HOST_GROUP = (dist.new_group(backend="gloo")
                       if dist.get_backend() != "gloo" else dist.group.WORLD)
    return ProcessInfo(dist.get_rank(), dist.get_world_size())


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if in_process_group() else 0


def process_count() -> int:
    return dist.get_world_size() if in_process_group() else 1


def in_multihost() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def _host_group():
    return _HOST_GROUP if _HOST_GROUP is not None else dist.group.WORLD


def barrier() -> None:
    """Block until every process reaches this point."""
    if in_process_group():
        dist.barrier(group=_host_group())


def allgather(value) -> np.ndarray:
    """Every process's ``value`` (an array or a number) on every process, as
    host numpy with a leading ``process_count`` axis."""
    value = np.asarray(value)
    if not in_process_group():
        return value[None]
    out = [None] * process_count()
    dist.all_gather_object(out, value, group=_host_group())
    return np.stack(out)


def local_batch_size(global_batch_size: int, count: Optional[int] = None) -> int:
    """Rows each process's loader yields so that the global batch is the
    config's ``batch_size``."""
    n = process_count() if count is None else count
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"process_count {n}")
    return global_batch_size // n


def process_slice(n: int, index: Optional[int] = None, count: Optional[int] = None) -> slice:
    """Balanced contiguous share of ``n`` items for this process (the first
    ``n % count`` processes take one extra)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    base, extra = divmod(n, count)
    start = index * base + min(index, extra)
    return slice(start, start + base + (1 if index < extra else 0))


def process_slice_even(n: int, index: Optional[int] = None,
                       count: Optional[int] = None) -> slice:
    """Equal contiguous shares (the trailing ``n % count`` items dropped),
    for loops in which every process must make the same collective calls."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    base = n // count
    return slice(index * base, (index + 1) * base)


def global_batch_from_local(rows: torch.Tensor) -> torch.Tensor:
    """The global batch from every process's local ``rows`` (equal shapes),
    concatenated in process order along axis 0, on every process. Over
    gloo, which gathers no 16-bit floats, those travel as float32 (exact)."""
    if not in_process_group():
        return rows
    wire = rows.contiguous()
    if dist.get_backend() == "gloo" and wire.is_floating_point() and wire.element_size() == 2:
        wire = wire.float()
    parts = [torch.empty_like(wire) for _ in range(process_count())]
    dist.all_gather(parts, wire)
    return torch.cat(parts).to(rows.dtype)


class BatchShard:
    """This process's view of a dataset read in global batches of
    ``global_batch`` rows: process r takes rows [r·b, (r+1)·b) of every
    full global batch (b = the local batch) and its ``process_slice`` of the
    trailing one, so that the processes' local batches, taken in order and
    concatenated, are the global batches of one process. A trailing batch of
    fewer rows than processes is dropped, so that every process runs the
    same number of steps. Other attributes are the dataset's."""

    def __init__(self, dataset, global_batch: int, index: Optional[int] = None,
                 count: Optional[int] = None):
        self.dataset = dataset
        self.index = process_index() if index is None else index
        self.count = process_count() if count is None else count
        self.local_batch = local_batch_size(global_batch, self.count)
        n = len(dataset)
        self._full, trailing = divmod(n, global_batch)
        self._global_batch = global_batch
        share = process_slice(trailing, self.index, self.count)
        self._trailing = share if trailing >= self.count else slice(0, 0)

    def __len__(self) -> int:
        return (self._full * self.local_batch
                + (self._trailing.stop - self._trailing.start))

    def global_index(self, index: int) -> int:
        if not 0 <= index < len(self):
            raise IndexError(index)
        batch, row = divmod(index, self.local_batch)
        if batch < self._full:
            return batch * self._global_batch + self.index * self.local_batch + row
        return self._full * self._global_batch + self._trailing.start + row

    def get_video_frame_indexes(self, index: int, epoch: int = 0):
        return self.dataset.get_video_frame_indexes(self.global_index(index), epoch)

    def get(self, index: int, epoch: int = 0, source=None):
        return self.dataset.get(self.global_index(index), epoch, source)

    def __getattr__(self, name):
        return getattr(self.dataset, name)
