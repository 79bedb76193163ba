"""Per-frame training sampling-weight construction (copy of the JAX package's
``core/sampling.py``).

Pure numpy/scipy host math. Two variants, matching the reference:

- ``ball_sampling_weights`` — 50/50 action-window/background sampling with
  optional out-of-fold-prediction hard-negative mining
  (reference ``src/ball_action/annotations.py:118-162``).
- ``action_sampling_weights`` — per-class weighted action sampling
  (reference ``src/action/annotations.py:129-152``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
from scipy.ndimage import maximum_filter1d


def _spread_background(weights: np.ndarray, action_prob: float) -> tuple[np.ndarray, float, np.ndarray]:
    """Distribute background probability mass uniformly over no-action frames
    so that action frames carry ``action_prob`` of the total mass."""
    no_action_mask = weights == 0.0
    no_action_count = int(no_action_mask.sum())
    no_action_weights_sum = (1.0 - action_prob) / action_prob * weights.sum()
    weights = weights.copy()
    weights[no_action_mask] = no_action_weights_sum / no_action_count
    return weights, no_action_weights_sum, no_action_mask


def ball_sampling_weights(
    video_data: dict,
    action_window_size: int,
    action_prob: float,
    clear_pred_window_size: int,
    oof_frame_indexes: Optional[np.ndarray] = None,
    oof_predictions: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-frame sampling distribution for one video (ball domain).

    Frames within ``action_window_size`` of an annotated action get weight 1;
    remaining probability mass is spread uniformly over background so actions
    are drawn with probability ``action_prob``. When out-of-fold raw
    predictions are provided, background weights are raised to the model's
    (max-over-class) confidence — hard-negative mining — except inside the
    ``clear_pred_window_size`` ring around true actions, and background mass
    is renormalized back to its original share
    (reference ``ball_action/annotations.py:118-162``).

    ``oof_predictions`` has shape ``(N, num_classes)`` aligned with
    ``oof_frame_indexes`` (a contiguous range as written by the predictor).
    """
    if clear_pred_window_size < action_window_size:
        raise ValueError("clear_pred_window_size must be >= action_window_size")

    weights = np.zeros(video_data["frame_count"], dtype=np.float64)
    for frame_index in video_data["frame_index2action"]:
        weights[frame_index] = 1.0

    clear_pred_mask = maximum_filter1d(weights, size=clear_pred_window_size)
    weights = maximum_filter1d(weights, size=action_window_size)
    clear_pred_mask = (clear_pred_mask - weights) == 1.0

    weights, no_action_weights_sum, no_action_mask = _spread_background(
        weights, action_prob
    )

    if oof_predictions is not None:
        assert oof_frame_indexes is not None
        confidences = np.max(oof_predictions, axis=1)
        start = int(oof_frame_indexes[0])
        end = int(oof_frame_indexes[-1]) + 1
        weights[start:end] = np.maximum(weights[start:end], confidences)
        # Reset the ring just outside the action window: confident predictions
        # adjacent to a true action are not negatives.
        no_action_count = int(no_action_mask.sum())
        weights[clear_pred_mask] = no_action_weights_sum / no_action_count
        weights[no_action_mask] *= (
            no_action_weights_sum / weights[no_action_mask].sum()
        )

    return weights / weights.sum()


def action_sampling_weights(
    video_data: dict,
    action_window_size: int,
    action_prob: float,
    action_weights: Optional[Mapping[str, float]] = None,
) -> np.ndarray:
    """Per-frame sampling distribution for one video (action domain).

    Like the ball variant but action frames carry per-class weights (rare
    classes get larger weight; reference ``action/annotations.py:129-152``),
    and annotations past the end of the video are clipped to the last frame.
    """
    frame_count = video_data["frame_count"]
    weights = np.zeros(frame_count, dtype=np.float64)
    for frame_index, action in video_data["frame_index2action"].items():
        if frame_index >= frame_count:
            frame_index = frame_count - 1
        value = action_weights[action] if action_weights is not None else 1.0
        weights[frame_index] = max(value, weights[frame_index])

    weights = maximum_filter1d(weights, size=action_window_size)
    weights, _, _ = _spread_background(weights, action_prob)
    return weights / weights.sum()


def videos_sampling_weights(videos_data, **kwargs) -> list[np.ndarray]:
    """Vector version over a list of video_data dicts (ball variant unless
    ``action_weights`` is passed)."""
    if "action_weights" in kwargs:
        return [action_sampling_weights(v, **kwargs) for v in videos_data]
    return [ball_sampling_weights(v, **kwargs) for v in videos_data]
