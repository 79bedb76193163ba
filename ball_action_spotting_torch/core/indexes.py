"""Temporal stack-window index math (copy of the JAX package's
``core/indexes.py``, the part inference needs)."""

from __future__ import annotations


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
