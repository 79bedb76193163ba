"""Host-side frame sources (copy of the JAX package's ``data/video.py``).

``FrameSource`` is a sequential-or-seek grayscale reader with a zero-frame
fallback on decode errors. ``SyntheticSource`` renders deterministic frames
for tests and benchmarks and ``HardSyntheticSource`` a low-contrast task
that does not saturate, ``OpenCVSource`` decodes on the CPU, and
``open_source`` picks one for a ``video_data`` dict (a ``<video>.gray``
store before the codec). ``SequentialWindowSource`` buffers a codec source
for time-ordered reads, so overlapping windows decode each frame once;
``make_sequential_factory`` wraps codec sources in it and passes stores and
synthetic sources through. ``make_synthetic_video_data`` builds
``video_data`` dicts of synthetic videos for training runs without the
dataset.
"""

from __future__ import annotations

import abc
import collections
import logging
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


class SequentialWindowSource(FrameSource):
    """Rolling-buffer wrapper for ordered access on codec-backed sources.

    A persistent decoder plus a window of decoded frames, so time-ordered
    samples (validation, whole-video predict without a ``.gray`` store)
    decode each frame once: overlapping strided windows are served from the
    buffer, the wrapped decoder only ever steps forward, and a backward seek
    outside the buffer resets it (one codec seek, not one per sample).
    Eviction drops the oldest-inserted frame; a window whose decode fails
    comes back with zero frames where frames are missing.
    """

    def __init__(self, source: FrameSource, buffer_size: int = 64):
        super().__init__(source.video_path)
        self._source = source
        self.num_frames = source.num_frames
        self.width = source.width
        self.height = source.height
        self.buffer_size = int(buffer_size)
        self._buffer: "collections.OrderedDict[int, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._next: Optional[int] = None  # wrapped source's next sequential index

    def _decode_at(self, index: int) -> np.ndarray:
        if self._next is not None and index == self._next:
            frame = self._source.fetch_frame()  # sequential step
        else:
            frame = self._source.fetch_frame(index)  # codec seek
        self._next = index + 1
        self._buffer[index] = frame
        while len(self._buffer) > self.buffer_size:
            self._buffer.popitem(last=False)
        return frame

    def _ensure(self, lo: int, hi: int) -> None:
        if hi - lo + 1 > self.buffer_size:
            self.buffer_size = hi - lo + 1  # never evict inside one window
        # mark present window frames most-recent BEFORE decoding the gaps:
        # eviction pops oldest-inserted, which could otherwise be a frame of
        # THIS window that entered the buffer long ago (it would then be
        # silently zero-filled by fetch_frames)
        for i in range(lo, hi + 1):
            if i in self._buffer:
                self._buffer.move_to_end(i)
        for i in range(lo, hi + 1):
            if i not in self._buffer:
                self._decode_at(i)

    def _seek_and_read(self, index: int) -> np.ndarray:
        self._ensure(index, index)
        return self._buffer[index]

    def _next_decode(self) -> np.ndarray:
        return self._seek_and_read(self.current_index)

    def fetch_frames(self, indexes: Sequence[int]) -> np.ndarray:
        lo, hi = min(indexes), max(indexes)
        try:
            self._ensure(lo, hi)
        except Exception:
            logger.exception(
                "Sequential window [%s, %s] error, video '%s'",
                lo, hi, self.video_path,
            )
        zero = None
        frames = []
        for i in indexes:
            frame = self._buffer.get(i)
            if frame is None:
                if zero is None:
                    zero = np.zeros((self.height, self.width), dtype=np.uint8)
                frame = zero
            frames.append(frame)
        return np.stack(frames, axis=0)

    def close(self) -> None:
        self._source.close()


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


class HardSyntheticSource(FrameSource):
    """Low-SNR spatiotemporal event task, frame for frame the JAX
    package's ``HardSyntheticSource``.

    The easy ``SyntheticSource`` task saturates (a tiny model reaches
    mAP@1 1.0 in a few epochs), so it can prove determinism but not that
    the recipe's stages work (stage 1 < stage 3, one fold < the fold
    ensemble). This task is built not to saturate:

    - the class signal is MOTION DIRECTION, not location or brightness: a
      small dim dot crosses the frame horizontally for class 0 and
      vertically for class 1 at a random position per event. A single
      frame cannot decide the class; the model must use the temporal
      stack (exactly the capability the MultiDimStacker exists for).
    - ``signal`` scales the dot's contrast over the noise floor
      (uniform background noise + moving gradient + per-frame global
      brightness wobble, which breaks intensity thresholds).
    - ``distractor_rate`` inserts class-confusable movers between events:
      identical dots moving diagonally, statically flickering, or along a
      class direction at the wrong speed. These produce exactly the false
      positives stage-3's OOF hard-negative sampling
      (``clear_pred_window_size``) exists to mine.

    Deterministic per ``(seed, index)`` — the mover schedule is drawn
    once at init; frames render independently (seekable, parity with the
    other sources).
    """

    DOT = 7  # dot side, px

    def __init__(
        self,
        video_path: str = "synthetic_hard",
        num_frames: int = 500,
        height: int = 64,
        width: int = 96,
        seed: int = 0,
        events: Optional[dict[int, int]] = None,  # frame index -> class idx
        event_window: int = 9,
        signal: float = 0.4,
        noise: int = 50,
        distractor_rate: float = 0.5,  # distractors per event
    ):
        super().__init__(video_path)
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.seed = seed
        self.events = dict(events or {})
        self.event_window = event_window
        self.signal = signal
        self.noise = noise

        rng = np.random.default_rng((seed * 9_369_319 + 7) % (2**63))
        h, w = height, width
        half_w = event_window // 2
        margin = self.DOT + 2
        # class velocity (px/frame): 0 = horizontal, 1 = vertical — at
        # stack step 2 the dot shifts ~5 px between stacked frames
        class_v = {0: (2.5, 0.0), 1: (0.0, 2.5)}
        self._movers: list[tuple[int, int, float, float, float, float, float]] = []

        def add_mover(f0, vx, vy, amp_scale=1.0):
            cx = float(rng.uniform(margin + abs(vx) * half_w,
                                   w - margin - abs(vx) * half_w))
            cy = float(rng.uniform(margin + abs(vy) * half_w,
                                   h - margin - abs(vy) * half_w))
            amp = 150.0 * signal * amp_scale * float(rng.uniform(0.8, 1.2))
            self._movers.append((f0 - half_w, f0 + half_w, cx, cy, vx, vy, amp))

        for f0 in sorted(self.events):
            vx, vy = class_v[self.events[f0] % 2]
            if rng.random() < 0.5:  # both travel directions per class
                vx, vy = -vx, -vy
            add_mover(f0, vx, vy)

        # distractors: confusable movers placed AWAY from event windows
        # (>= 15 frames ~ within the mAP@1 tolerance margin) so they are
        # unambiguous hard negatives, never mislabeled positives
        n_distract = int(round(distractor_rate * max(1, len(self.events))))
        event_frames = np.asarray(sorted(self.events), dtype=np.int64)
        kinds = ["diag", "flash", "fast"]
        placed = 0
        for _ in range(20 * n_distract):
            if placed >= n_distract:
                break
            f0 = int(rng.integers(half_w + 1, num_frames - half_w - 1))
            if event_frames.size and np.abs(event_frames - f0).min() < 15:
                continue
            kind = kinds[placed % len(kinds)]
            if kind == "diag":
                sx, sy = rng.choice([-1.0, 1.0]), rng.choice([-1.0, 1.0])
                add_mover(f0, 1.8 * sx, 1.8 * sy)
            elif kind == "flash":
                add_mover(f0, 0.0, 0.0)
            else:  # class-direction at the wrong (double) speed
                vx, vy = class_v[placed % 2]
                add_mover(f0, 2 * vx, 2 * vy)
            placed += 1

    def _frame(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) % (2**63))
        h, w = self.height, self.width
        frame = rng.integers(0, max(1, self.noise), size=(h, w),
                             dtype=np.uint8).astype(np.int32)
        # moving gradient + global brightness wobble (breaks absolute-
        # intensity shortcuts; same texture family as SyntheticSource)
        row = (np.arange(w) + 3 * index) % w
        frame[: h // 2] += (row // 4)[None, :]
        frame += int(rng.integers(0, 25))
        d = self.DOT
        for f_lo, f_hi, cx, cy, vx, vy, amp in self._movers:
            if not (f_lo <= index <= f_hi):
                continue
            t = index - (f_lo + f_hi) / 2.0
            x = int(round(cx + vx * t))
            y = int(round(cy + vy * t))
            y0, y1 = max(0, y - d // 2), min(h, y + d // 2 + 1)
            x0, x1 = max(0, x - d // 2), min(w, x + d // 2 + 1)
            frame[y0:y1, x0:x1] += int(amp)
        return np.clip(frame, 0, 255).astype(np.uint8)

    def _next_decode(self) -> np.ndarray:
        if self.current_index >= self.num_frames:
            raise RuntimeError("eof")
        return self._frame(self.current_index)

    def _seek_and_read(self, index: int) -> np.ndarray:
        if index >= self.num_frames:
            raise RuntimeError("eof")
        return self._frame(index)

    def render_all(self) -> np.ndarray:
        """All frames as one (num_frames, H, W) uint8 array, for writing
        gray stores that the CLIs then read."""
        return np.stack([self._frame(i) for i in range(self.num_frames)])


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
    from ball_action_spotting_torch.data.gray_store import GrayStoreSource, store_path_for_video

    gray = store_path_for_video(path)
    if gray.exists():
        return GrayStoreSource(gray)
    return OpenCVSource(path)


def make_sequential_factory(buffer_size: int, base_factory=open_source):
    """Source factory for time-ordered consumers (validation enumerates
    actions in video order): wraps CODEC-backed sources in
    ``SequentialWindowSource`` so overlapping windows decode each frame once.
    Random-access stores (gray/synthetic) pass through — buffering would
    only add copies."""

    def factory(video_data: dict) -> FrameSource:
        src = base_factory(video_data)
        if isinstance(src, OpenCVSource):
            return SequentialWindowSource(src, buffer_size=buffer_size)
        return src

    return factory
