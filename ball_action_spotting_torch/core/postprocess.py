"""Raw per-frame scores → discrete action spots (copy of the JAX package's
``core/postprocess.py`` host path): a 1D Gaussian smooth followed by
``scipy.signal.find_peaks``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import find_peaks

from ball_action_spotting_torch.domains.base import Domain


def post_processing(
    frame_indexes: Sequence[int],
    predictions: np.ndarray,
    gauss_sigma: float,
    height: float,
    distance: int,
) -> tuple[list[int], list[float]]:
    """Smooth one class's score curve and extract peaks.

    Returns (action frame indexes, confidences). ``frame_indexes`` must be a
    contiguous range; only its first element is used as the offset.
    """
    smoothed = gaussian_filter1d(np.asarray(predictions, dtype=np.float64), gauss_sigma)
    peaks, _ = find_peaks(smoothed, height=height, distance=distance)
    confidences = smoothed[peaks].tolist()
    action_frame_indexes = (peaks + int(frame_indexes[0])).tolist()
    return action_frame_indexes, confidences


def raw_predictions_to_actions(
    frame_indexes: Sequence[int],
    raw_predictions: np.ndarray,
    domain: Domain,
    verbose: bool = True,
) -> dict[str, tuple[list[int], list[float]]]:
    """Per-class peak extraction over a (frames, num_classes) score matrix."""
    class2actions = {}
    for cls, cls_index in domain.class2target.items():
        class2actions[cls] = post_processing(
            frame_indexes,
            raw_predictions[:, cls_index],
            **domain.postprocess.as_dict(),
        )
        if verbose:
            print(f"Predicted {len(class2actions[cls][0])} {cls} actions")
    return class2actions
