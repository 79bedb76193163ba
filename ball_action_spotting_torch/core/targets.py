"""Frame-index → multilabel target construction (copy of the JAX package's
``core/targets.py``).

Pure numpy. Parity with the reference's ``VideoTarget`` and max-window
target reduction (reference ``src/target.py``). Returns numpy arrays —
the device framework only enters at the batching boundary.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class VideoTarget:
    """Per-video lookup from frame index to one-hot-per-class targets.

    Built from a video's ``frame_index2action`` annotation dict; also keeps
    an ordered action-index → frame-index map for validation enumeration
    (reference ``src/target.py:8-40``). Actions whose label is not in
    ``classes`` (e.g. synthetic "EMPTY") still occupy an action index but
    contribute a zero target.
    """

    def __init__(self, video_data: dict, classes: Sequence[str]):
        self.classes = list(classes)
        self.num_classes = len(self.classes)
        class2target = {cls: i for i, cls in enumerate(self.classes)}

        self._frame2target: dict[int, np.ndarray] = {}
        self.action_index2frame_index: dict[int, int] = {}

        items = sorted(video_data["frame_index2action"].items(), key=lambda kv: kv[0])
        for action_index, (frame_index, action) in enumerate(items):
            self.action_index2frame_index[action_index] = frame_index
            if action in class2target:
                target = self._frame2target.setdefault(
                    frame_index, np.zeros(self.num_classes, dtype=np.float32)
                )
                target[class2target[action]] = 1.0

    def target(self, frame_index: int) -> np.ndarray:
        hit = self._frame2target.get(frame_index)
        if hit is not None:
            return hit.copy()
        return np.zeros(self.num_classes, dtype=np.float32)

    def targets(self, frame_indexes: Sequence[int]) -> np.ndarray:
        out = np.zeros((len(frame_indexes), self.num_classes), dtype=np.float32)
        for row, idx in enumerate(frame_indexes):
            hit = self._frame2target.get(idx)
            if hit is not None:
                out[row] = hit
        return out

    def get_frame_index_by_action_index(self, action_index: int) -> int:
        return self.action_index2frame_index[action_index]

    def num_actions(self) -> int:
        return len(self.action_index2frame_index)


def center_crop_targets(targets: np.ndarray, crop_size: int) -> np.ndarray:
    """Center-crop the time axis to ``crop_size`` rows
    (reference ``src/target.py:43-47``)."""
    extra = targets.shape[0] - crop_size
    left = extra // 2
    right = extra - left
    return targets[left : targets.shape[0] - right]


class MaxWindowTargetsProcessor:
    """Crop the per-frame target matrix to ``window_size`` around the center,
    then max over time → a single multilabel vector. This realizes the
    "positive label within the window" rule (reference ``src/target.py:56-65``).
    """

    def __init__(self, window_size: int):
        self.window_size = window_size

    def __call__(self, targets: np.ndarray) -> np.ndarray:
        targets = targets.astype(np.float32, copy=False)
        targets = center_crop_targets(targets, self.window_size)
        return np.amax(targets, axis=0)
