"""A (data, model) grid of devices for inference in one process (port of the
JAX package's ``parallel/mesh.py``).

JAX lays its chips out as a ``jax.sharding.Mesh`` and lets GSPMD split one
jitted program over it. The port keeps the grid and does the split itself:
the chunked engine runs each data-axis device's share of a chunk's
predictions (``ChunkedVideoPredictor(mesh=...)``), and the fused ensemble
puts its folds on the model-axis devices (``FusedFoldsPredictor(
fold_parallel=True)``). Each device's work is launched on that device's own
current stream, with no process group. Training runs one process per device
over ``torch.distributed`` instead (``parallel/multihost.py``); there the
global-batch BatchNorm statistics that GSPMD gives JAX come from an
all-reduce (``models/effnetv2.py::BatchNormAct``).

The model axis holds the two stages of a pipeline-parallel train step
(``parallel/pipeline.py``, one process), the slices of a tensor-parallel
training state (``parallel/sharding_rules.py``, one process per grid row)
and the height bands of spatial partitioning (``parallel/spatial.py``:
``spatial_bands`` gives a data row's devices and cuts, the port's
``spatial_frames_sharding``); ``model_devices(row)`` lists a row's.
``batch_slices`` splits a batch over the data axis, the port's
``batch_sharding``.

A device may repeat in the grid (``make_mesh(2, 1, ["cuda:0", "cuda:0"])``),
so that one card, or the CPU, runs a 2×1 or 1×2 grid.

Not ported: ``replicated``, ``shard_batch`` and ``replicate_state``, which
place JAX arrays (the port's callers move tensors with ``.to(device)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ball_action_spotting_torch.parallel.spatial import balanced_cuts

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``grid[i][j]`` is the device at data index i and model index j."""

    grid: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.grid), MODEL_AXIS: len(self.grid[0])}

    def data_devices(self) -> list[torch.device]:
        """The devices along the data axis (model index 0)."""
        return [row[0] for row in self.grid]

    def model_devices(self, row: int = 0) -> list[torch.device]:
        """The devices along the model axis of data row ``row``."""
        return list(self.grid[row])

    def batch_slices(self, n: int) -> list[slice]:
        """Equal contiguous shares of a batch of ``n`` rows, one per data
        row, in order; ``n`` must divide evenly."""
        n_data = len(self.grid)
        if n % n_data:
            raise ValueError(f"a batch of {n} rows does not divide over a data axis of "
                             f"{n_data}")
        share = n // n_data
        return [slice(i * share, (i + 1) * share) for i in range(n_data)]


def spatial_bands(mesh: DeviceMesh, rows: int,
                  row: int = 0) -> tuple[list[torch.device], tuple[int, ...]]:
    """Spatial partitioning's cut of ``rows`` frame rows over data row
    ``row``'s model-axis devices: (the devices, the n + 1 global row cuts).
    Band i holds ``process_slice(rows, i, n_model)``; bands past ``rows``
    are empty."""
    devices = mesh.model_devices(row)
    return devices, balanced_cuts(rows, len(devices))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (n_data, n_model) grid over ``devices`` (by default every visible
    CUDA device), filled row by row; ``n_data`` defaults to as many rows as
    the devices fill."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu', ...] "
                               "to lay a grid over the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) grid needs {n_data * n_model} devices, "
                         f"got {len(devices)}")
    grid = tuple(tuple(devices[i * n_model:(i + 1) * n_model]) for i in range(n_data))
    return DeviceMesh(grid)


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device, so
    that a grid's devices compare equal to those of the tensors on them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def pad_batch_to_devices(frames: np.ndarray, targets: np.ndarray, n: int):
    """Pad a trailing partial batch so that its leading dim divides ``n``;
    returns (frames, targets, valid_count).

    Padding cycles the real rows (row ``b+i`` duplicates row ``i % b``), so
    that the duplicates, which do enter the unmasked train loss, weigh as
    evenly as they can."""
    b = frames.shape[0]
    pad = (-b) % n
    if pad:
        idx = np.arange(b + pad) % b
        frames = frames[idx]
        targets = targets[idx]
    return frames, targets, b
