"""Clip datasets: sampling + fetch + pad, host-side numpy (copy of the JAX
package's ``data/dataset.py``).

Each training sample's RNG derives from (base_seed, epoch, index), so the
port draws the same clips as the JAX package. Frames stay uint8 on the
host; the /255 normalize happens on the device in the train step.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Sequence

import numpy as np

from ball_action_spotting_torch.core.indexes import FrameIndexShaker, StackIndexesGenerator
from ball_action_spotting_torch.core.targets import VideoTarget
from ball_action_spotting_torch.data.video import FrameSource, open_source


def pad_frames(frames: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Symmetric zero-pad (T, H, W) to size=(W, H)
    (reference ``src/frames.py:12-31``; size is (width, height) as in configs)."""
    h, w = frames.shape[-2:]
    hp, wp = size[1] - h, size[0] - w
    if hp < 0 or wp < 0:
        raise ValueError(f"Frames {frames.shape} larger than pad size {size}")
    if hp == 0 and wp == 0:
        return frames
    top, left = hp // 2, wp // 2
    return np.pad(
        frames,
        [(0, 0)] * (frames.ndim - 2) + [(top, hp - top), (left, wp - left)],
        mode="constant",
    )


class ClipDataset(abc.ABC):
    """Indexable dataset of (uint8 clip (T,H,W), float32 multilabel target)."""

    def __init__(
        self,
        videos_data: list[dict],
        classes: Sequence[str],
        indexes_generator: StackIndexesGenerator,
        target_process_fn: Callable[[np.ndarray], np.ndarray],
        image_size: Optional[tuple[int, int]] = None,  # (W, H) pad target
        source_factory: Callable[[dict], FrameSource] = open_source,
    ):
        self.videos_data = videos_data
        self.classes = list(classes)
        self.indexes_generator = indexes_generator
        self.target_process_fn = target_process_fn
        self.image_size = image_size
        self.source_factory = source_factory

        self.num_videos = len(videos_data)
        self.num_videos_actions = [len(v["frame_index2action"]) for v in videos_data]
        self.num_actions = sum(self.num_videos_actions)
        self.videos_target = [VideoTarget(v, self.classes) for v in videos_data]

    def __len__(self) -> int:
        return self.num_actions

    @abc.abstractmethod
    def get_video_frame_indexes(self, index: int, epoch: int = 0) -> tuple[int, list[int]]: ...

    def get_targets(self, video_index: int, frame_indexes: list[int]) -> np.ndarray:
        target_indexes = list(range(min(frame_indexes), max(frame_indexes) + 1))
        return self.videos_target[video_index].targets(target_indexes)

    def get(
        self,
        index: int,
        epoch: int = 0,
        source: Optional[FrameSource] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        video_index, frame_indexes = self.get_video_frame_indexes(index, epoch)
        if source is None:
            with self.source_factory(self.videos_data[video_index]) as src:
                frames = src.fetch_frames(frame_indexes)
        else:
            frames = source.fetch_frames(frame_indexes)
        targets = self.get_targets(video_index, frame_indexes)
        if self.image_size is not None:
            frames = pad_frames(frames, self.image_size)
        return frames, self.target_process_fn(targets).astype(np.float32)


class TrainClipDataset(ClipDataset):
    """Weighted random sampling with save-zone clipping and index shake
    (reference ``TrainActionDataset``, ``datasets.py:85-127``)."""

    def __init__(
        self,
        *args,
        epoch_size: int,
        videos_sampling_weights: list[np.ndarray],
        frame_index_shaker: Optional[FrameIndexShaker] = None,
        base_seed: int = 0,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.epoch_size = epoch_size
        self.frame_index_shaker = frame_index_shaker
        self.base_seed = base_seed
        self.videos_sampling_weights = videos_sampling_weights
        self.videos_frame_indexes = [
            np.arange(v["frame_count"]) for v in self.videos_data
        ]

    def __len__(self) -> int:
        return self.epoch_size

    def sample_rng(self, index: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.base_seed, epoch, index])
        )

    def get_video_frame_indexes(self, index: int, epoch: int = 0) -> tuple[int, list[int]]:
        rng = self.sample_rng(index, epoch)
        video_index = int(rng.integers(0, self.num_videos))
        frame_index = int(
            rng.choice(
                self.videos_frame_indexes[video_index],
                p=self.videos_sampling_weights[video_index],
            )
        )
        save_zone = 1
        if self.frame_index_shaker is not None:
            save_zone += self.frame_index_shaker.max_shift
        frame_index = self.indexes_generator.clip_index(
            frame_index, self.videos_data[video_index]["frame_count"], save_zone
        )
        frame_indexes = self.indexes_generator.make_stack_indexes(frame_index)
        if self.frame_index_shaker is not None:
            frame_indexes = self.frame_index_shaker(frame_indexes, rng)
        return video_index, frame_indexes


class ValClipDataset(ClipDataset):
    """Enumerates every annotated action (incl. synthetic EMPTY), in video
    order (reference ``ValActionDataset``, ``datasets.py:130-145``)."""

    def get_video_frame_indexes(self, index: int, epoch: int = 0) -> tuple[int, list[int]]:
        if not 0 <= index < len(self):
            raise IndexError(f"index {index} outside [0, {len(self)})")
        action_index = index
        video_index = 0
        for video_index, num in enumerate(self.num_videos_actions):
            if action_index >= num:
                action_index -= num
            else:
                break
        frame_index = self.videos_target[video_index].get_frame_index_by_action_index(
            action_index
        )
        frame_index = self.indexes_generator.clip_index(
            frame_index, self.videos_data[video_index]["frame_count"], 1
        )
        return video_index, self.indexes_generator.make_stack_indexes(frame_index)
