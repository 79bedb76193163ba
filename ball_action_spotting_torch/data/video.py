"""Host-side frame sources (copy of the JAX package's ``data/video.py``,
without the buffering ``SequentialWindowSource``).

``FrameSource`` is a sequential-or-seek grayscale reader with a zero-frame
fallback on decode errors. ``SyntheticSource`` renders deterministic frames
for tests and benchmarks, ``OpenCVSource`` decodes on the CPU, and
``open_source`` picks one for a ``video_data`` dict;
``make_synthetic_video_data`` builds ``video_data`` dicts of synthetic
videos for training runs without the dataset.
"""

from __future__ import annotations

import abc
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class FrameSource(abc.ABC):
    """Sequential-or-seek grayscale frame reader for one video."""

    def __init__(self, video_path: str):
        self.video_path = str(video_path)
        self.num_frames: int = 0
        self.width: int = 0
        self.height: int = 0
        self.current_index: int = -1

    @abc.abstractmethod
    def _seek_and_read(self, index: int) -> np.ndarray: ...

    @abc.abstractmethod
    def _next_decode(self) -> np.ndarray: ...

    def fetch_frame(self, index: Optional[int] = None) -> np.ndarray:
        """Next frame (index None) or the frame at ``index``; on decode error
        returns a zero frame."""
        try:
            if index is None or index == self.current_index + 1:
                self.current_index += 1
                return self._next_decode()
            self.current_index = index
            return self._seek_and_read(index)
        except Exception:
            logger.exception("Fetch frame %s error, video '%s'", index, self.video_path)
            return np.zeros((self.height, self.width), dtype=np.uint8)

    def fetch_frames_into(self, indexes: Sequence[int], out: np.ndarray) -> None:
        """Fetch a strided window directly into ``out`` ((len(indexes), h, w)
        view of a pooled batch buffer)."""
        out[:] = self.fetch_frames(indexes)

    def fetch_frames(self, indexes: Sequence[int]) -> np.ndarray:
        """Fetch a strided window: decode [min, max] sequentially, keep the
        requested indexes. Returns (len(indexes), H, W) uint8."""
        start, end = min(indexes), max(indexes)
        wanted = {start: self.fetch_frame(start)}
        need = set(indexes)
        for idx in range(start + 1, end + 1):
            frame = self.fetch_frame()
            if idx in need:
                wanted[idx] = frame
        return np.stack([wanted[i] for i in indexes], axis=0)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class OpenCVSource(FrameSource):
    """CPU decode via OpenCV/FFmpeg, BGR→grayscale."""

    def __init__(self, video_path: str):
        super().__init__(video_path)
        import cv2

        self._cv2 = cv2
        self._cap = cv2.VideoCapture(str(video_path), cv2.CAP_FFMPEG)
        self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))

    def _next_decode(self) -> np.ndarray:
        ok, frame = self._cap.read()
        if not ok:
            raise RuntimeError(f"Decode failed at {self.current_index}")
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY)

    def _seek_and_read(self, index: int) -> np.ndarray:
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, index)
        return self._next_decode()

    def close(self) -> None:
        self._cap.release()


class SyntheticSource(FrameSource):
    """Deterministic procedural frames for tests/benchmarks.

    Frame content is a cheap hash-driven pattern of (video seed, index); a
    bright square appears near event frames, at a per-class location.
    Frame for frame the same as the JAX package's ``SyntheticSource``.
    """

    def __init__(
        self,
        video_path: str = "synthetic",
        num_frames: int = 500,
        height: int = 64,
        width: int = 96,
        seed: int = 0,
        events: Optional[dict[int, int]] = None,  # frame index -> class index
        event_window: int = 4,
    ):
        super().__init__(video_path)
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.seed = seed
        self.events = dict(events or {})
        self._event_frames = np.asarray(sorted(self.events), dtype=np.int64)
        self.event_window = event_window

    def _frame(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed * 1_000_003 + index) % (2**63))
        frame = rng.integers(0, 60, size=(self.height, self.width), dtype=np.uint8)
        # moving gradient background
        row = (np.arange(self.width) + 3 * index) % self.width
        frame[: self.height // 2] += (row // 4).astype(np.uint8)[None, :]
        if self._event_frames.size:
            dist = np.abs(self._event_frames - index)
            nearest = int(np.argmin(dist))
            if dist[nearest] <= self.event_window:
                cls = self.events[int(self._event_frames[nearest])]
                h, w = self.height, self.width
                x0 = (w // 8) * (1 + 2 * (cls % 4))
                frame[h // 4 : h // 2, x0 : x0 + w // 8] = 250
        return frame

    def _next_decode(self) -> np.ndarray:
        if self.current_index >= self.num_frames:
            raise RuntimeError("eof")
        return self._frame(self.current_index)

    def _seek_and_read(self, index: int) -> np.ndarray:
        if index >= self.num_frames:
            raise RuntimeError("eof")
        return self._frame(index)


def make_synthetic_video_data(
    num_videos: int = 2,
    num_frames: int = 400,
    classes: Sequence[str] = ("PASS", "DRIVE"),
    every: int = 40,
    height: int = 64,
    width: int = 96,
) -> list[dict]:
    """video_data dicts of synthetic videos (``synthetic://<v>``, read by
    ``SyntheticSource``): class i events on frames every·k + 10·i."""
    videos = []
    for v in range(num_videos):
        frame_index2action = {}
        for k in range(1, num_frames // every):
            frame_index2action[k * every] = classes[k % len(classes)]
        videos.append(dict(
            video_path=f"synthetic://{v}",
            game=f"synthetic_game_{v}",
            half=1,
            frame_count=num_frames,
            fps=25.0,
            width=width,
            height=height,
            frame_index2action=frame_index2action,
            classes=list(classes),
            synthetic_seed=v,
        ))
    return videos


def open_source(video_data: dict) -> FrameSource:
    """FrameSource factory from a video_data dict.

    Resolution order: synthetic:// URIs → SyntheticSource; a sibling
    ``<video>.gray`` store (decode-once transcode) → GrayStoreSource;
    otherwise OpenCV/FFmpeg decode.
    """
    path = video_data["video_path"]
    if str(path).startswith("synthetic://"):
        classes = video_data.get("classes")
        events = {}
        for f, a in video_data["frame_index2action"].items():
            if a == "EMPTY":
                continue
            events[f] = classes.index(a) if classes else 0
        return SyntheticSource(
            video_path=path,
            num_frames=video_data["frame_count"],
            height=video_data["height"],
            width=video_data["width"],
            seed=video_data.get("synthetic_seed", 0),
            events=events,
        )
    gray = Path(str(path) + ".gray")
    if gray.exists():
        from ball_action_spotting_torch.data.gray_store import GrayStoreSource

        return GrayStoreSource(gray)
    return OpenCVSource(path)
