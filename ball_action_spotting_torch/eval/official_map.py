"""Official SoccerNet ``average_mAP`` algorithm, reimplemented faithfully
(copy of the JAX package's ``eval/official_map.py``; numpy only).

The reference delegates the headline metric to the SoccerNet pip package
(reference ``src/evaluate.py:9-11,137-139``): label/prediction JSONs
are rasterized into dense per-frame vectors, a per-class "closest action"
vector attributes every frame to its nearest ground truth (for the
visible/unshown splits, ``src/evaluate.py:95-120``), and AP is computed from
200-threshold precision/recall curves after greedy one-to-one matching.

This module mirrors that official pipeline's exact semantics, all of which
differ subtly from the definitional matcher in ``soccernet_map.py``:

- **frame mapping truncates**: ``frame = int(framerate * position_ms/1000)``
  (not round);
- vectors are a fixed **90-minute timeline** (``90*60*framerate`` frames),
  later spots clamp to the last frame;
- two annotations of one class on the same frame **collide** (one dense
  cell — the duplicate is not counted twice);
- ground truth cells hold **+1 (visible) / -1 (unshown)**; the closest-action
  vector propagates that sign to every frame for split attribution;
- matching: per class, ground truths in ascending frame order each claim the
  highest-confidence unmatched prediction with ``|pred-gt| <= delta/2``
  (delta in frames = tolerance-seconds x framerate);
- per-threshold counting over ``linspace(0,1,200)`` with 0/0 -> 0
  (``np.nan_to_num``); AP is the official **11-point interpolation**
  (mean over recall levels j in {0, .1, ..., 1} of the max precision among
  points with recall >= j). 11-point — not trapezoidal AUC — is the only
  recipe consistent with the empty-threshold convention: thresholds above
  the best confidence yield (precision 0, recall 0) points that would
  poison a trapezoid (perfect predictions would score 0.75) but are
  harmless under interpolation;
- a class with **zero ground truths scores AP 0** and stays in the mean.

``evaluate_games(..., algorithm="official")`` uses this path; the
definitional matcher remains as ``algorithm="matcher"`` and the two are
cross-checked property-style in ``tests/test_eval_official.py``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from ball_action_spotting_torch.domains.base import Domain


def vector_size(framerate: float) -> int:
    return int(90 * 60 * framerate)


def label_vectors(
    labels: dict, domain: Domain, framerate: float
) -> dict[int, np.ndarray]:
    """Per-half dense (V, C) ground-truth vectors: +1 visible, -1 unshown
    (official ``label2vector`` semantics)."""
    size = vector_size(framerate)
    out = {half: np.zeros((size, domain.num_classes)) for half in domain.halves}
    class2idx = domain.class2target
    for ann in labels["annotations"]:
        half = int(ann["gameTime"].split(" - ")[0])
        if half not in out:
            continue
        label = ann["label"]
        label = domain.merged_classes.get(label, label)
        if label not in class2idx:
            continue
        frame = int(framerate * (int(ann["position"]) / 1000))
        frame = min(frame, size - 1)
        value = -1.0 if ann.get("visibility") == "not shown" else 1.0
        out[half][frame, class2idx[label]] = value
    return out


def prediction_vectors(
    predictions: dict, domain: Domain, framerate: float
) -> dict[int, np.ndarray]:
    """Per-half dense (V, C) confidence vectors, -1 where no prediction
    (official ``predictions2vector`` semantics)."""
    size = vector_size(framerate)
    out = {half: np.zeros((size, domain.num_classes)) - 1 for half in domain.halves}
    inverse_output_map = {v: k for k, v in domain.output_class_map.items()}
    class2idx = domain.class2target
    for pred in predictions["predictions"]:
        half = int(pred["half"])
        if half not in out:
            continue
        label = inverse_output_map.get(pred["label"], pred["label"])
        label = domain.merged_classes.get(label, label)
        if label not in class2idx:
            continue
        frame = int(framerate * (int(pred["position"]) / 1000))
        frame = min(frame, size - 1)
        out[half][frame, class2idx[label]] = float(pred["confidence"])
    return out


def closest_vector(label_vec: np.ndarray) -> np.ndarray:
    """Per-class nearest-action attribution (reference
    ``src/evaluate.py:95-107`` semantics, reimplemented): the timeline is
    partitioned at midpoints between consecutive ground truths; each segment
    carries its action's value (+1/-1). Classes with no actions stay -1."""
    size, num_classes = label_vec.shape
    closest = np.full(label_vec.shape, -1.0)
    for c in range(num_classes):
        frames = np.flatnonzero(label_vec[:, c])
        if len(frames) == 0:
            continue
        # extended boundary list: mirror before the first, far past the last
        ext = np.concatenate(([-frames[0]], frames, [2 * size]))
        for k in range(1, len(ext) - 1):
            start = max(0, (ext[k - 1] + ext[k]) // 2)
            stop = min(size, (ext[k] + ext[k + 1]) // 2)
            closest[start:stop, c] = label_vec[ext[k], c]
    return closest


def match_class_scores(
    target: np.ndarray, closest: np.ndarray, detection: np.ndarray, delta: float
) -> tuple[np.ndarray, int, int]:
    """Official ``compute_class_scores``: greedy one-to-one matching on one
    class of one half. Returns ([conf, matched, closest_value] per
    prediction, n visible GT, n unshown GT)."""
    gt_frames = np.flatnonzero(target)
    n_visible = int((target > 0).sum())
    n_unshown = int((target < 0).sum())
    pred_frames = np.flatnonzero(detection >= 0)
    scores = detection[pred_frames]

    dets = np.zeros((len(pred_frames), 3))
    dets[:, 0] = scores
    dets[:, 2] = closest[pred_frames]

    taken = np.zeros(len(pred_frames), dtype=bool)
    half_window = delta / 2
    for gt in gt_frames:
        best = -1
        best_score = -1.0
        for i, (frame, score) in enumerate(zip(pred_frames, scores)):
            if frame > gt + half_window:
                break
            if abs(frame - gt) <= half_window and not taken[i] and score > best_score:
                best, best_score = i, score
        if best >= 0:
            taken[best] = True
            dets[best, 1] = 1.0
    return dets, n_visible, n_unshown


def _ap_from_curve(precision: np.ndarray, recall: np.ndarray) -> float:
    """Official 11-point interpolated AP (see module docstring).

    The recall grid is ``np.arange(0, 1.1, 0.1)`` — the official package's
    expression — NOT ``arange(11)/10``: the two differ in float64 at
    0.3/0.6/0.7 (e.g. 0.30000000000000004 vs 0.3), which changes whether a
    max-recall point sitting exactly on the boundary is counted."""
    ap = 0.0
    for j in np.arange(0, 1.1, 0.1):
        at_least = precision[recall >= j]
        if at_least.size:
            ap += float(at_least.max())
    return ap / 11


def _threshold_curves(dets: np.ndarray, total_gt: int,
                      num_thresholds: int = 200) -> tuple[np.ndarray, np.ndarray]:
    """Official per-threshold precision/recall counting with 0/0 -> 0."""
    thresholds = np.linspace(0, 1, num_thresholds)
    conf = dets[:, 0]
    matched = dets[:, 1]
    precision = np.zeros(num_thresholds)
    recall = np.zeros(num_thresholds)
    for i, thr in enumerate(thresholds):
        mask = conf >= thr
        n_pred = int(mask.sum())
        tp = float(matched[mask].sum())
        precision[i] = tp / n_pred if n_pred else 0.0   # nan_to_num(0/0)
        recall[i] = tp / total_gt if total_gt else 0.0  # nan_to_num(0/0)
    return precision, recall


def average_map_official(
    targets: Sequence[np.ndarray],
    detections: Sequence[np.ndarray],
    closests: Sequence[np.ndarray],
    framerate: float,
    deltas: np.ndarray,
) -> tuple[float, list, Optional[float], Optional[list], Optional[float], Optional[list]]:
    """Official ``average_mAP``: (a_mAP, per-class, visible, per-class
    visible, unshown, per-class unshown). Inputs are aligned per-half dense
    vectors (V, C)."""
    num_classes = targets[0].shape[1]
    maps, maps_vis, maps_uns = [], [], []
    per_class_all, per_class_vis_all, per_class_uns_all = [], [], []

    for delta_s in deltas:
        delta = float(delta_s) * framerate
        ap, ap_vis, ap_uns = [], [], []
        for c in range(num_classes):
            all_dets = []
            n_vis = n_uns = 0
            for target, closest, detection in zip(targets, closests, detections):
                dets, v, u = match_class_scores(
                    target[:, c], closest[:, c], detection[:, c], delta
                )
                all_dets.append(dets)
                n_vis += v
                n_uns += u
            dets = (
                np.concatenate(all_dets, axis=0) if all_dets else np.zeros((0, 3))
            )
            p, r = _threshold_curves(dets, n_vis + n_uns)
            ap.append(_ap_from_curve(p, r))

            # split curves: exclude predictions attributed to the other kind
            dets_vis = dets.copy()
            dets_vis[dets_vis[:, 2] <= 0.5, 0] = -1
            p, r = _threshold_curves(dets_vis, n_vis)
            ap_vis.append(_ap_from_curve(p, r))

            dets_uns = dets.copy()
            dets_uns[dets_uns[:, 2] >= -0.5, 0] = -1
            p, r = _threshold_curves(dets_uns, n_uns)
            ap_uns.append(_ap_from_curve(p, r))

        per_class_all.append(ap)
        per_class_vis_all.append(ap_vis)
        per_class_uns_all.append(ap_uns)
        maps.append(float(np.mean(ap)))
        maps_vis.append(float(np.mean(ap_vis)))
        maps_uns.append(float(np.mean(ap_uns)))

    a_map = float(np.mean(maps))
    per_class = list(np.mean(np.asarray(per_class_all), axis=0))
    a_map_vis = float(np.mean(maps_vis))
    per_class_vis = list(np.mean(np.asarray(per_class_vis_all), axis=0))
    a_map_uns = float(np.mean(maps_uns))
    per_class_uns = list(np.mean(np.asarray(per_class_uns_all), axis=0))
    return a_map, per_class, a_map_vis, per_class_vis, a_map_uns, per_class_uns
