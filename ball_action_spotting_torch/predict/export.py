"""Sealed serving artifacts: the chunk program as one ``torch.export`` file
(port of the JAX package's ``predict/export.py``).

``export_chunked_predictor`` traces a ``ChunkedVideoPredictor``'s
frame-carry chunk program with ``torch.export``, BN already folded and the
weights inside, and writes it with the geometry the host loop needs. A
``FusedFoldsPredictor`` is sealed whole: its predictions carry a fold axis
and the header gives ``num_folds``. The three kernels are ``torch.library``
custom ops (``ops/``), so the traced graph holds them as nodes and the
loaded program launches them on a CUDA device. ``ExportedChunkPredictor``
reloads the file with the op registrations alone: no model code, no
config, no checkpoint parsing. It runs on the ``device`` it is given,
whatever device the program was traced on: an artifact traced on the CPU
serves on the card (the counterpart of JAX's ``platforms=("cpu", "tpu")``).

File layout: ``MAGIC | u64 len | header JSON | u64 len | torch.export.save
bytes``. The header holds chunk_size, overlap, image_size, num_classes,
num_folds, frame_stack_size, frame_stack_step, tta and, in place of JAX's
``platforms``, ``traced_device``.
"""

from __future__ import annotations

import io
import json
import struct
import warnings
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
from torch import nn

import ball_action_spotting_torch.ops  # noqa: F401  (registers the bas_torch ops)
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.device import resolve_device
from ball_action_spotting_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from ball_action_spotting_torch.predict.host_loop import run_chunk_loop

_MAGIC = b"BASTORX1"


class _ChunkProgram(nn.Module):
    """A predictor's frame-carry chunk program as a module whose
    submodules are the predictor's models, so that ``torch.export`` lifts
    their weights into the program."""

    def __init__(self, predictor):
        super().__init__()
        self.models = nn.ModuleList(getattr(predictor, "models", [predictor.model]))
        fused = hasattr(predictor, "num_folds")
        self._call = predictor.fused_frames if fused else predictor.chunk_frames

    def forward(self, new_frames: torch.Tensor, carry: torch.Tensor):
        return self._call(new_frames, carry)


def export_chunked_predictor(predictor, path: Path | str) -> Path:
    """Seal the predictor's frame-carry chunk program (a feature-carry
    predictor gives the same predictions through it) into ``path``, traced
    on the predictor's device under ``torch.no_grad``.

    The program must hold the ``bas_torch::dwconv3d`` op, so the predictor
    must be built with ``dw3d_use_kernel=True``: an artifact holds whatever
    its trace ran, and the grouped conv traced on the CPU would run as
    cuDNN's grouped conv on the card. A predictor on a grid of more than
    one device is refused: the artifact is a one-device program; spread it
    at load time by building a live engine with ``mesh=`` instead."""
    from ball_action_spotting_torch.models.blocks3d import DepthwiseConv3d

    if predictor.mesh.shape != {DATA_AXIS: 1, MODEL_AXIS: 1} or \
            getattr(predictor, "fold_parallel", False):
        raise ValueError("export of mesh-sharded chunk programs is not supported; "
                         "export the single-device predictor")
    models = getattr(predictor, "models", [predictor.model])
    if any(isinstance(m, DepthwiseConv3d) and not m.use_kernel
           for model in models for m in model.modules()):
        raise ValueError("export seals the depthwise kernel's route: build the predictor "
                         "with dw3d_use_kernel=True")
    tw, th = predictor.image_size
    dev = predictor.device
    args = (torch.zeros((predictor.chunk_size, th, tw), dtype=torch.uint8, device=dev),
            torch.zeros((predictor.overlap, th, tw), dtype=torch.uint8, device=dev))
    with torch.no_grad():
        program = torch.export.export(_ChunkProgram(predictor), args)
    blob = io.BytesIO()
    torch.export.save(program, blob)
    header = json.dumps({
        "format": 1,
        "chunk_size": predictor.chunk_size,
        "overlap": predictor.overlap,
        "image_size": [tw, th],
        "num_classes": int(predictor.model.num_classes),
        "num_folds": getattr(predictor, "num_folds", None),
        "frame_stack_size": predictor.frame_stack_size,
        "frame_stack_step": predictor.frame_stack_step,
        "tta": bool(predictor.tta),
        "traced_device": str(dev),
    }).encode()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        for part in (header, blob.getvalue()):
            f.write(struct.pack("<Q", len(part)))
            f.write(part)
    return path


def read_artifact(path: Path | str) -> tuple[dict, bytes]:
    """(header, program bytes) of an artifact; raises ``ValueError`` on a
    file of another magic or format."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"Not a bas-torch exported artifact: {path}")
        parts = []
        for _ in range(2):
            (n,) = struct.unpack("<Q", f.read(8))
            parts.append(f.read(n))
    meta = json.loads(parts[0].decode())
    if meta.get("format") != 1:
        raise ValueError(f"Unknown artifact format: {meta}")
    return meta, parts[1]


class ExportedChunkPredictor:
    """Run a sealed chunk-program artifact on ``device`` (default
    ``"cuda"``): the ``predict_video`` contract of ``ChunkedVideoPredictor``
    with no model code."""

    def __init__(self, path: Path | str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.meta, blob = read_artifact(path)
        with warnings.catch_warnings():  # the weights are read, never written
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            program = torch.export.load(io.BytesIO(blob))
        if torch.device(self.meta["traced_device"]) != self.device:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self.program = program
        self._module = program.module()
        self.chunk_size = self.meta["chunk_size"]
        self.overlap = self.meta["overlap"]
        self.image_size = tuple(self.meta["image_size"])  # (W, H)
        self.num_classes = self.meta["num_classes"]
        self.num_folds = self.meta.get("num_folds")
        self.tta = self.meta["tta"]
        self.indexes_generator = StackIndexesGenerator(
            self.meta["frame_stack_size"], self.meta["frame_stack_step"])

    def upload(self, frames_u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(frames_u8).to(self.device)

    def chunk(self, new_frames: torch.Tensor, carry: torch.Tensor):
        """One chunk program: (chunk, H, W) u8 + (overlap, H, W) u8 on the
        device → (predictions, carry)."""
        return self._module(new_frames, carry)

    def predict_video(self, frames: Iterator[tuple[int, np.ndarray]],
                      frame_count: int) -> tuple[list[int], np.ndarray]:
        with torch.inference_mode():
            return run_chunk_loop(
                self.chunk,
                indexes_generator=self.indexes_generator,
                chunk_size=self.chunk_size,
                overlap=self.overlap,
                image_size=self.image_size,
                num_classes=((self.num_folds, self.num_classes) if self.num_folds
                             else self.num_classes),
                frames=frames,
                frame_count=frame_count,
                put_new=self.upload,
                put_carry=self.upload,
            )
