"""Raw per-frame scores → discrete action spots (copy of the JAX package's
``core/postprocess.py``): a 1D Gaussian smooth followed by
``scipy.signal.find_peaks`` on the host, and ``smooth_scores_batch``, the
same smooth of many class curves at once on a device.

scipy's and JAX's boundary mode "reflect" repeats the edge sample, which
numpy calls "symmetric"; ``F.pad(mode="reflect")`` skips it (numpy's
"reflect"), so the device path builds its pad from flipped slices."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter1d
from scipy.signal import find_peaks

from ball_action_spotting_torch.device import resolve_device
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


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """The truncated Gaussian kernel scipy's ``gaussian_filter1d`` uses
    (truncate=4.0)."""
    if radius is None:
        radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / phi.sum()


def _pad_symmetric(rows: torch.Tensor, radius: int) -> torch.Tensor:
    """numpy's "symmetric" pad of the last axis by ``radius`` on each side:
    the edge sample repeated. A radius past the row's length goes on
    reflecting what is already padded, as numpy and scipy do."""
    while radius > 0:
        k = min(radius, rows.shape[-1])
        rows = torch.cat([rows[..., :k].flip(-1), rows, rows[..., -k:].flip(-1)], dim=-1)
        radius -= k
    return rows


def smooth_scores_batch(scores: np.ndarray, gauss_sigma: float,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Gaussian-smooth a (num_classes, frames) or (frames,) score array on
    ``device`` in float32 (scipy's default "reflect" boundary), returned as
    numpy."""
    device = resolve_device(device)
    kernel = torch.from_numpy(gaussian_kernel1d(gauss_sigma)).to(device, torch.float32)
    radius = (kernel.shape[0] - 1) // 2
    rows = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=device)
    squeeze = rows.ndim == 1
    if squeeze:
        rows = rows[None, :]
    padded = _pad_symmetric(rows, radius)
    # JAX convolves (its kernel flipped into a correlation); conv1d
    # correlates, so the kernel is flipped here too
    out = F.conv1d(padded[:, None, :], kernel.flip(0)[None, None, :])[:, 0, :]
    if squeeze:
        out = out[0]
    return out.cpu().numpy()
