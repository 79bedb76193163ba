"""The gray store: the decode-once ``<video>.gray`` file of the JAX
package's ``data/gray_store.py`` (24-byte header ``GRAYSTR1``, uint32
height, uint32 width, uint64 frame count, then raw uint8 frames).

``transcode_video_to_store`` decodes a video once (OpenCV/FFmpeg) into a
store; ``write_gray_store`` writes one from any frames. ``GrayStore`` reads
it through the native threaded gather of ``csrc/gray_store.cpp`` (built with
g++ at first use, ``native.py``), or, with ``native=False``, through a numpy
memmap: the plain version the tests hold the native reader to. Nothing
picks the numpy reader on its own: a failed build raises.

The native gather writes into any view whose rows are contiguous, such as
the loader's padded batch slot ``frames_buf[j][:, 8:728, :]`` (720 stored
rows in 736): the C entry point takes the output's clip, frame and row
strides.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ball_action_spotting_torch.data.video import FrameSource, OpenCVSource
from ball_action_spotting_torch.native import HostLibrary

_HEADER = 24
_MAGIC = b"GRAYSTR1"

LIBRARY = HostLibrary("gray_store")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types."""
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    signatures = {
        "gray_store_open": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)],
        "gray_store_info": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)],
        "gray_store_read": [ctypes.c_void_p, i64, i64, p_u8],
        "gray_store_gather": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), i64, i64, p_u8,
                              i64, i64, i64, ctypes.c_int],
        "gray_store_close": [ctypes.c_void_p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


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


def transcode_video_to_store(video_path: Path, store_path: Path) -> dict:
    """Decode a video once (OpenCV/FFmpeg) into a grayscale store; returns
    its info (height, width, frame_count, fps)."""
    src = OpenCVSource(str(video_path))
    try:
        info = dict(height=src.height, width=src.width, frame_count=src.num_frames,
                    fps=src.fps)
        frames = (src.fetch_frame() for _ in range(src.num_frames))
        write_gray_store(store_path, frames, src.height, src.width, src.num_frames)
    finally:
        src.close()
    return info


def store_path_for_video(video_path: str | Path) -> Path:
    return Path(str(video_path) + ".gray")


def _check_out(out: np.ndarray, shape: tuple) -> None:
    """Check that ``out`` is a writable uint8 array of ``shape`` whose rows
    are contiguous and lie in increasing order (the native gather's layout)."""
    if out.dtype != np.uint8 or out.shape != shape:
        raise ValueError(f"out must be uint8 of shape {shape}, got {out.dtype} {out.shape}")
    if not out.flags.writeable:
        raise ValueError("out is read-only")
    if out.strides[-1] != 1 or any(s < 0 for s in out.strides):
        raise ValueError(f"out's rows must be contiguous, got strides {out.strides}")


class GrayStore:
    """Reader over one store file: the native threaded gather, or with
    ``native=False`` the numpy memmap (the plain version)."""

    def __init__(self, path: Path, num_threads: int = 4, native: bool = True):
        self.path = Path(path)
        self.num_threads = num_threads
        self.native = native
        self._handle = None
        self._mmap = None
        if native:
            self._lib = _bind(LIBRARY.load())
            handle = ctypes.c_void_p()
            rc = self._lib.gray_store_open(str(self.path).encode(), ctypes.byref(handle))
            if rc != 0:
                raise OSError(f"gray_store_open failed rc={rc}: {self.path}")
            self._handle = handle
            h, w, n = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint64()
            self._lib.gray_store_info(handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(n))
            self.height, self.width, self.frame_count = h.value, w.value, n.value
        else:
            with open(self.path, "rb") as f:
                head = f.read(_HEADER)
            if head[:8] != _MAGIC or len(head) < _HEADER:
                raise OSError(f"not a gray store: {self.path}")
            self.height = int(np.frombuffer(head[8:12], np.uint32)[0])
            self.width = int(np.frombuffer(head[12:16], np.uint32)[0])
            self.frame_count = int(np.frombuffer(head[16:24], np.uint64)[0])
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r", offset=_HEADER,
                                   shape=(self.frame_count, self.height, self.width))

    def read(self, start: int, count: int) -> np.ndarray:
        """Frames [start, start + count) as a new (count, H, W) array."""
        if not (0 <= start and count >= 0 and start + count <= self.frame_count):
            raise IndexError(f"frames [{start}, {start + count}) outside "
                             f"[0, {self.frame_count}) of {self.path}")
        out = np.empty((count, self.height, self.width), dtype=np.uint8)
        if self.native:
            rc = self._lib.gray_store_read(self._handle, start, count,
                                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                raise IndexError(f"gray_store_read rc={rc}")
        else:
            out[:] = self._mmap[start:start + count]
        return out

    def gather(self, clip_indexes: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """(num_clips, frames_per_clip) int64 indexes → uint8 clips
        (num_clips, frames_per_clip, H, W), out-of-range indexes clamped to
        the store. ``out`` may be any view with contiguous rows, such as a
        padded slot of a pooled batch buffer."""
        clip_indexes = np.ascontiguousarray(clip_indexes, dtype=np.int64)
        nc, fpc = clip_indexes.shape
        shape = (nc, fpc, self.height, self.width)
        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        _check_out(out, shape)
        if self.native:
            rc = self._lib.gray_store_gather(
                self._handle, clip_indexes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                nc, fpc, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.strides[0], out.strides[1], out.strides[2], self.num_threads)
            if rc != 0:
                raise RuntimeError(f"gray_store_gather rc={rc}: {self.path}")
        else:
            clamped = np.clip(clip_indexes, 0, self.frame_count - 1)
            for i in range(nc):
                for j in range(fpc):
                    out[i, j] = self._mmap[clamped[i, j]]
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.gray_store_close(self._handle)
            self._handle = None
        self._mmap = None

    def __del__(self):
        self.close()


class GrayStoreSource(FrameSource):
    """FrameSource over one store file, read through ``GrayStore``."""

    def __init__(self, store_path: Path, num_threads: int = 4):
        super().__init__(str(store_path))
        self.store = GrayStore(store_path, num_threads=num_threads)
        self.num_frames = self.store.frame_count
        self.height = self.store.height
        self.width = self.store.width

    def _next_decode(self) -> np.ndarray:
        return self._seek_and_read(self.current_index)

    def _seek_and_read(self, index: int) -> np.ndarray:
        return self.store.read(index, 1)[0]

    def fetch_frames(self, indexes: Sequence[int]) -> np.ndarray:
        # random access is free: gather exactly the strided indexes
        clip = np.asarray(indexes, dtype=np.int64)[None, :]
        return self.store.gather(clip)[0]

    def fetch_frames_into(self, indexes: Sequence[int], out: np.ndarray) -> None:
        """Gather the frames at ``indexes`` (clamped to the video) into
        ``out``, a (len(indexes), H, W) view with contiguous rows."""
        clip = np.asarray(indexes, dtype=np.int64)[None, :]
        self.store.gather(clip, out=out[None])

    def close(self) -> None:
        self.store.close()
