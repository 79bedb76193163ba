"""Temporal stack-window index math and index jitter (copy of the JAX
package's ``core/indexes.py``). Randomness flows through an explicit
``numpy.random.Generator``, so sampling is reproducible."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class StackIndexesGenerator:
    """Symmetric window of ``size`` frame indexes spaced ``step`` apart.

    For a center frame ``c``, yields ``size`` indexes
    ``[c - behind, ..., c + ahead]`` with spacing ``step``, where
    ``behind = (size // 2) * step`` and ``ahead = (size - size//2 - 1) * step``.
    """

    def __init__(self, size: int, step: int):
        if size <= 0 or step <= 0:
            raise ValueError("size and step must be positive")
        self.size = size
        self.step = step
        self.behind = (size // 2) * step
        self.ahead = (size - size // 2 - 1) * step

    def make_stack_indexes(self, frame_index: int) -> list[int]:
        return list(
            range(frame_index - self.behind, frame_index + self.ahead + 1, self.step)
        )

    def clip_index(self, index: int, frame_count: int, save_zone: int = 0) -> int:
        """Clamp a center index so the whole window (plus margin) stays
        in-bounds."""
        lo = self.behind + save_zone
        hi = frame_count - self.ahead - save_zone - 1
        if index < lo:
            return lo
        if index > hi:
            return hi
        return index


class FrameIndexShaker:
    """Per-frame random index jitter (temporal augmentation).

    With probability ``prob``, each index in the stack is independently
    shifted by a value drawn from ``shifts`` with probabilities ``weights``
    (reference ``src/indexes.py:35-52``).
    """

    def __init__(
        self,
        shifts: Sequence[int],
        weights: Optional[Sequence[float]] = None,
        prob: float = 1.0,
    ):
        self.shifts = list(shifts)
        self.weights = list(weights) if weights is not None else None
        self.prob = prob

    @property
    def max_shift(self) -> int:
        return max(abs(s) for s in self.shifts)

    def __call__(
        self, frame_indexes: Sequence[int], rng: np.random.Generator
    ) -> list[int]:
        if rng.random() >= self.prob:
            return list(frame_indexes)
        shifts = rng.choice(self.shifts, size=len(frame_indexes), p=self.weights)
        return [int(i + s) for i, s in zip(frame_indexes, shifts)]
