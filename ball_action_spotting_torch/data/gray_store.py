"""Read side of the gray store: the decode-once ``<video>.gray`` file the
JAX package's ``data/gray_store.py`` writes (24-byte header ``GRAYSTR1``,
uint32 height, uint32 width, uint64 frame count, then raw uint8 frames),
read here through a numpy memmap."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ball_action_spotting_torch.data.video import FrameSource

_HEADER = 24
_MAGIC = b"GRAYSTR1"


class GrayStoreSource(FrameSource):
    """FrameSource over one store file."""

    def __init__(self, store_path: Path):
        super().__init__(str(store_path))
        with open(store_path, "rb") as f:
            head = f.read(_HEADER)
        if head[:8] != _MAGIC:
            raise ValueError(f"Not a gray store: {store_path}")
        self.height = int(np.frombuffer(head[8:12], np.uint32)[0])
        self.width = int(np.frombuffer(head[12:16], np.uint32)[0])
        self.num_frames = int(np.frombuffer(head[16:24], np.uint64)[0])
        self._mmap = np.memmap(store_path, dtype=np.uint8, mode="r", offset=_HEADER,
                               shape=(self.num_frames, self.height, self.width))

    def _next_decode(self) -> np.ndarray:
        return self._seek_and_read(self.current_index)

    def _seek_and_read(self, index: int) -> np.ndarray:
        if not 0 <= index < self.num_frames:
            raise IndexError(f"frame {index} outside [0, {self.num_frames})")
        return np.array(self._mmap[index])

    def fetch_frames(self, indexes: Sequence[int]) -> np.ndarray:
        # random access is free: gather exactly the strided indexes
        out = np.empty((len(indexes), self.height, self.width), np.uint8)
        self.fetch_frames_into(indexes, out)
        return out

    def fetch_frames_into(self, indexes: Sequence[int], out: np.ndarray) -> None:
        """Gather the frames at ``indexes`` (clamped to the video) into
        ``out``."""
        clamped = np.clip(np.asarray(indexes, dtype=np.int64), 0, self.num_frames - 1)
        for i, index in enumerate(clamped):
            out[i] = self._mmap[index]

    def close(self) -> None:
        self._mmap = None
