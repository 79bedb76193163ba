"""The gray store: the decode-once ``<video>.gray`` file of the JAX
package's ``data/gray_store.py`` (24-byte header ``GRAYSTR1``, uint32
height, uint32 width, uint64 frame count, then raw uint8 frames), written
by ``write_gray_store`` and read through a numpy memmap."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ball_action_spotting_torch.data.video import FrameSource

_HEADER = 24
_MAGIC = b"GRAYSTR1"


def write_gray_store(path: Path, frames_iter, height: int, width: int,
                     frame_count: int) -> None:
    """Write an iterable of (H, W) uint8 frames into a store file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint32(height).tobytes())
        f.write(np.uint32(width).tobytes())
        f.write(np.uint64(frame_count).tobytes())
        written = 0
        for frame in frames_iter:
            frame = np.ascontiguousarray(frame, dtype=np.uint8)
            if frame.shape != (height, width):
                raise ValueError(f"frame {written} has shape {frame.shape}, "
                                 f"expected {(height, width)}")
            f.write(frame.tobytes())
            written += 1
    if written != frame_count:
        raise ValueError(f"wrote {written} frames to {path}, the header says {frame_count}")


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
