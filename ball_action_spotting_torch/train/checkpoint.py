"""Checkpoints (port of the JAX package's ``train/checkpoint.py``).

A ``BASTPU01`` checkpoint is the 8 magic bytes followed by three blobs, each
prefixed by its little-endian uint64 length: a header JSON (the experiment's
params dict), the EMA variable tree and the raw (non-EMA) variable tree,
both Flax msgpack (``train/msgpack.py``). The port reads the checkpoints the
JAX training CLIs write, and writes checkpoints the JAX package reads.

The mid-run resume point is port-native (``torch.save`` of the model, EMA
and optimizer state), since the JAX package's holds optax's state layout.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ball_action_spotting_torch.train.msgpack import packb, unpackb

CKPT_SUFFIX = ".ckpt"
_MAGIC = b"BASTPU01"


def save_checkpoint(path: Path, params_dict: dict, variables: dict,
                    no_ema_variables: Optional[dict] = None) -> None:
    """Single-file checkpoint: header JSON (model params/config) + the EMA
    and raw variable trees (numpy Flax trees, ``convert.state_dict_to_flax_tree``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = json.dumps({"model_name": "BallActionModel", "params": params_dict}).encode()
    raw = packb(no_ema_variables) if no_ema_variables is not None else b""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        for blob in (header, packb(variables), raw):
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)


def load_checkpoint(path: Path, use_ema: bool = True) -> tuple[dict, dict]:
    """Returns (variables as a numpy tree, params_dict)."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"Not a bas-tpu checkpoint: {path}")
        blobs = []
        for _ in range(3):
            (n,) = struct.unpack("<Q", f.read(8))
            blobs.append(f.read(n))
    header = json.loads(blobs[0].decode())
    if not use_ema and not blobs[2]:
        raise ValueError(f"Checkpoint {path} has no raw (non-EMA) weights")
    return unpackb(blobs[1] if use_ema else blobs[2]), header["params"]


def checkpoint_name(epoch: int, score: float) -> str:
    return f"model-{epoch:03d}-{score:.6f}{CKPT_SUFFIX}"


def get_best_checkpoint_path(
    dir_path: Path, return_score: bool = False, more_better: bool = True,
    tie_keep: str = "last",
):
    """Best ``.ckpt`` by the score in its filename
    ``model-{epoch:03d}-{score:.6f}.ckpt``. ``tie_keep`` breaks exact score
    ties: ``"last"`` prefers the later epoch, ``"first"`` the earlier one."""
    if tie_keep not in ("first", "last"):
        raise ValueError(f"tie_keep must be 'first' or 'last', got {tie_keep!r}")
    dir_path = Path(dir_path)
    scored = []
    for path in dir_path.glob(f"*{CKPT_SUFFIX}"):
        m = re.search(r"-(\d+(?:\.\d+)?)\.ckpt$", path.name)
        if m:
            scored.append((path, float(m.group(1))))
    if not scored:
        return (None, -np.inf) if return_score else None

    def epoch_of(path: Path) -> int:
        m = re.search(r"model-(\d+)-", path.name)
        return int(m.group(1)) if m else -1

    epoch_sign = -1 if tie_keep == "last" else 1
    scored.sort(key=lambda x: (-x[1] if more_better else x[1], epoch_sign * epoch_of(x[0])))
    best, score = scored[0]
    return (best, score) if return_score else best


def resolve_pretrain_variables(path: Path, use_ema: bool = True) -> tuple[dict, dict]:
    """Load a native ``.ckpt`` checkpoint. The JAX package also reads
    reference ``.pth`` files and Orbax directories; the port does not yet."""
    path = Path(path)
    if path.suffix == ".pth" or path.is_dir():
        raise ValueError(
            f"{path}: the port loads .ckpt checkpoints only (.pth and Orbax "
            "directories are not ported yet)")
    return load_checkpoint(path, use_ema=use_ema)


class CheckpointManager:
    """Retention of the ``max_saves`` best checkpoints by score (higher is
    better). ``tie_keep``: which epoch
    survives when scores tie exactly, ``"first"`` (the default, argus'
    stable-sort retention) or ``"last"`` (the most recent equal-best epoch,
    for a monitor metric that saturates early)."""

    def __init__(self, save_dir: Path, max_saves: int = 1, tie_keep: str = "first"):
        if tie_keep not in ("first", "last"):
            raise ValueError(f"tie_keep must be 'first' or 'last', got {tie_keep!r}")
        self.save_dir = Path(save_dir)
        self.max_saves = max_saves
        self.tie_keep = tie_keep
        self._seq = 0
        self._saved: list[tuple[float, int, Path]] = []

    def save(self, epoch: int, score: float, params_dict: dict, variables: dict,
             no_ema_variables: Optional[dict] = None) -> Path:
        path = self.save_dir / checkpoint_name(epoch, score)
        save_checkpoint(path, params_dict, variables, no_ema_variables)
        self._saved.append((score, self._seq, path))
        self._seq += 1
        self._saved.sort(key=lambda x: (-x[0], -x[1] if self.tie_keep == "last" else x[1]))
        while len(self._saved) > self.max_saves:
            self._saved.pop()[2].unlink(missing_ok=True)
        return path


def transfer_weights(state: dict[str, torch.Tensor], pretrain: dict[str, torch.Tensor],
                     verbose: bool = True) -> dict[str, torch.Tensor]:
    """Copy the pretrain entries whose shapes match; keep the target's where
    they differ (the 2→15 class and 15→33 frame transfers). Both state
    dicts must have the same keys."""
    if set(state) != set(pretrain):
        raise ValueError("transfer_weights needs state dicts with the same keys")
    out = {}
    for name, target in state.items():
        pre = pretrain[name]
        if tuple(target.shape) == tuple(pre.shape):
            out[name] = pre.to(target.dtype)
        else:
            if verbose:
                print(f"Layer '{name}' has different shape in pretrain "
                      f"{tuple(target.shape)} != {tuple(pre.shape)}. Skip loading.")
            out[name] = target
    return out


def save_train_state(path: Path, state, epoch: int, best: dict | None = None) -> None:
    """The full training state (model, EMA, optimizer, step) for mid-run
    resume, written atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({"epoch": epoch, "best": best or {}, **state.state_dict()}, tmp)
    tmp.replace(path)


def load_train_state(path: Path, state) -> tuple[Any, int, dict]:
    """Restore ``save_train_state``'s file into ``state`` (a freshly built
    TrainState); returns (state, next_epoch, best)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(blob)
    return state, int(blob["epoch"]) + 1, blob["best"]


def snapshot_experiment(save_dir: Path, config: dict,
                        extra_files: dict[str, str] | None = None) -> None:
    """Write the resolved config (and any source snapshots) into the
    experiment dir."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    def default(o: Any):
        if isinstance(o, Path):
            return str(o)
        if isinstance(o, (np.integer, np.floating)):
            return o.item()
        return repr(o)

    (save_dir / "config.json").write_text(json.dumps(config, indent=4, default=default))
    for name, content in (extra_files or {}).items():
        (save_dir / name).write_text(content)
