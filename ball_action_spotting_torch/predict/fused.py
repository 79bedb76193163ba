"""Fused multi-fold ensemble: decode and upload each video once, run every
fold's model on each chunk (port of the JAX package's ``predict/fused.py``).

The challenge submission predicts every challenge game with all seven fold
models. Run fold by fold, each video is decoded, padded and uploaded seven
times. ``FusedFoldsPredictor`` uploads each chunk's frames once and, per
chunk, loops over the folds running the single-fold chunk program of
``ChunkedVideoPredictor`` with that fold's model (the JAX package scans the
stacked fold weights with ``lax.scan``): each fold's predictions are
numerically the single-fold engine's. Host work and the frame tail are paid
once; device work still grows with the folds.

With ``carry_features=True`` (the default) every fold carries its own
encoded overlap-stack features between chunks. ``mesh=`` spreads each fold's
chunk over the grid's data axis, as ``ChunkedVideoPredictor(mesh=)`` does.
``fold_parallel=True`` puts the folds on the grid's model axis instead: the
fold list is padded to a multiple of the axis by repeating fold 0 (the
padding's predictions are dropped), the frames are copied to every device,
and each device runs the single-fold program over its own folds with their
own feature carries.

Per-fold outputs are written in the npz/JSON layout of the per-fold loop
(``predict/pipeline.py::predict_games_fused``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

from ball_action_spotting_torch.parallel.mesh import DATA_AXIS
from ball_action_spotting_torch.predict.host_loop import run_chunk_loop
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor


def _check_compatible(params_a: dict, params_b: dict, path_a, path_b) -> None:
    """All folds share the architecture and the window geometry: one chunk
    loop serves them all."""
    for key in ("nn_module", "frame_stack_size", "frame_stack_step", "frames_processor"):
        a, b = params_a.get(key), params_b.get(key)
        if _canon(a) != _canon(b):  # checkpoints round-trip tuples as lists
            raise ValueError(f"Fused folds require identical {key!r}: "
                             f"{path_a} has {a!r}, {path_b} has {b!r}")


def _canon(obj):
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(x) for x in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _canon(v)) for k, v in obj.items()))
    return obj


class FusedFoldsPredictor(ChunkedVideoPredictor):
    """Chunked engine over N checkpoints at once (see module docstring).

    ``predict_video`` returns raw predictions of shape (T, folds, classes);
    ``raw[:, i]`` is fold i's. Weights come from ``checkpoint_paths`` or, in
    memory, ``weights=[(state_dict, params), ...]``."""

    def __init__(self, checkpoint_paths: Sequence[Path | str] = (), tta: bool = False,
                 use_ema: bool = True, dtype: torch.dtype = torch.bfloat16,
                 fold_bn: bool = True, dw3d_use_kernel: bool | None = None,
                 device: str | torch.device = "cuda", chunk_size: int = 128,
                 carry_features: bool = True, mesh=None, fold_parallel: bool = False,
                 weights: Sequence[tuple[dict, dict]] | None = None, s2d_stem: bool = False):
        sources = ([{"weights": w} for w in weights] if weights is not None
                   else [{"checkpoint_path": Path(p)} for p in checkpoint_paths])
        if not sources:
            raise ValueError("checkpoint_paths must name at least one checkpoint")
        if fold_parallel and mesh is None:
            raise ValueError("fold_parallel=True requires mesh= (the folds go over the "
                             "mesh's 'model' axis)")
        if fold_parallel and mesh.shape[DATA_AXIS] != 1:
            raise ValueError(
                "fold_parallel puts the folds on the 'model' axis and copies the frames to "
                f"every device; a data axis > 1 would duplicate work (got data="
                f"{mesh.shape[DATA_AXIS]}). Use make_mesh(1, n), or mesh= without "
                "fold_parallel to share the frames instead")
        if fold_parallel:
            device = mesh.model_devices()[0]
        super().__init__(**sources[0], tta=tta, use_ema=use_ema, dtype=dtype,
                         fold_bn=fold_bn, dw3d_use_kernel=dw3d_use_kernel, device=device,
                         chunk_size=chunk_size, carry_features=carry_features,
                         mesh=None if fold_parallel else mesh, s2d_stem=s2d_stem)
        self.fold_parallel = fold_parallel
        self.num_folds = len(sources)
        names = [src.get("checkpoint_path", f"weights[{i}]") for i, src in enumerate(sources)]
        models = [self.model]
        for name, src in zip(names[1:], sources[1:]):
            model, params = self.load_model(**src)
            _check_compatible(self.params, params, names[0], name)
            models.append(model)
        self.models = models

        # each (padded) fold's shares of a chunk, [(device, model)]: one
        # model-axis device under fold_parallel, else the data axis
        if fold_parallel:
            devices = mesh.model_devices()
            padded = models + [models[0]] * ((-len(models)) % len(devices))
            per_device = len(padded) // len(devices)
            self.fold_shares = [self.place(m, [devices[i // per_device]])
                                for i, m in enumerate(padded)]
        else:
            self.fold_shares = [self.shares] + [self.place(m, self.mesh.data_devices())
                                                for m in models[1:]]

    # --- device programs -------------------------------------------------

    def _on_fold_devices(self, *tensors) -> dict:
        """``tensors`` on the first device of every fold's shares, copied
        before any fold's work is queued: a copy between devices runs on
        its source device's stream, behind the work already there."""
        devices = dict.fromkeys(shares[0][0] for shares in self.fold_shares)
        return {dev: [t.to(dev) for t in tensors] for dev in devices}

    def _gather(self, preds: list) -> torch.Tensor:
        """Per padded fold (N, classes) → (N, folds, classes) on the first
        device, the padding dropped."""
        return torch.stack([p.to(self.device) for p in preds[:self.num_folds]], dim=1)

    def fused_frames(self, new_frames: torch.Tensor, carry):
        """Frame carry over the folds: (N, H, W) u8 + (overlap, H, W) u8 →
        ((N, folds, classes), carry)."""
        inputs = self._on_fold_devices(new_frames, carry)
        outs = [self.chunk_frames(*inputs[shares[0][0]], shares) for shares in self.fold_shares]
        return self._gather([p for p, _ in outs]), outs[0][1]

    def fused_features(self, new_frames: torch.Tensor, carry):
        """Feature carry over the folds: (N, H, W) u8 + (frame tail, per-fold
        feature tails) → ((N, folds, classes), carry)."""
        tail_u8, feat_carries = carry
        inputs = self._on_fold_devices(new_frames, tail_u8)
        outs = []
        for shares, fc in zip(self.fold_shares, feat_carries):
            new, tail = inputs[shares[0][0]]
            outs.append(self.chunk_features(new, (tail, fc), shares))
        return self._gather([p for p, _ in outs]), (outs[0][1][0], [c[1] for _, c in outs])

    def init_carry(self, first_frames_u8: np.ndarray):
        """The frame carry, or the frame tail and each fold's bootstrapped
        feature tail (on the device of the fold's first share)."""
        frames = self.upload(first_frames_u8)
        if not self.carry_features:
            return frames
        firsts = self._on_fold_devices(frames)
        feats = [self.bootstrap(firsts[shares[0][0]][0], shares[0][1])[1]
                 for shares in self.fold_shares]
        return frames[-self._frame_tail:], feats

    def chunk_call(self):
        return self.fused_features if self.carry_features else self.fused_frames

    def predict_video(self, frames: Iterator[tuple[int, np.ndarray]],
                      frame_count: int) -> tuple[list[int], np.ndarray]:
        """Like the single-fold engine, but the raw predictions are
        (num_predictions, num_folds, num_classes)."""
        with torch.inference_mode():
            return run_chunk_loop(
                self.chunk_call(),
                indexes_generator=self.indexes_generator,
                chunk_size=self.chunk_size,
                overlap=self.overlap,
                image_size=self.image_size,
                num_classes=(self.num_folds, self.model.num_classes),
                frames=frames,
                frame_count=frame_count,
                put_new=self.upload,
                put_carry=self.init_carry,
            )
