"""Checkpoint loading (port of the JAX package's ``train/checkpoint.py``,
load side only).

A ``BASTPU01`` checkpoint is the 8 magic bytes followed by three blobs, each
prefixed by its little-endian uint64 length: a header JSON (the experiment's
params dict), the EMA variable tree and the raw (non-EMA) variable tree,
both Flax msgpack (decoded by ``train/msgpack.py``). The port therefore
loads exactly the checkpoints that the JAX training CLIs write.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path

import numpy as np

from ball_action_spotting_torch.train.msgpack import unpackb

CKPT_SUFFIX = ".ckpt"
_MAGIC = b"BASTPU01"


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
