"""Average-mAP spotting evaluation (SoccerNet-style), self-contained (copy
of the JAX package's ``eval/soccernet_map.py``; numpy only).

The reference wraps the SoccerNet pip package's ``average_mAP``
(reference ``src/evaluate.py:9-11,137-139``). That package is an
optional dependency here; this module reimplements the published metric from
its definition (SoccerNet action spotting, Giancola et al.):

- a prediction spot is a true positive if it falls within a tolerance window
  of total size δ *centered* on a ground-truth spot of the same class
  (|pred - gt| ≤ δ·framerate/2), with one-to-one matching: ground truths are
  scanned in temporal order and each takes the highest-confidence unmatched
  prediction inside its window;
- per class, a precision/recall curve is swept over 200 confidence
  thresholds in [0, 1] and AP is the official 11-point interpolation,
  matching the official implementation's numeric recipe exactly;
- average-mAP averages the per-class AP over a set of tolerances δ:
  metric "at1" → δ = {1 s} (the headline mAP@1), "tight" → δ = 1..5 s,
  "loose" → δ = 5,10,...,60 s (``src/evaluate.py:122-127``).

``evaluate_games`` computes the metric with one of two algorithms:
``"official"`` (default) — the faithful reimplementation of the SoccerNet
package pipeline in ``eval/official_map.py`` (dense 90-minute vectors,
truncating frame mapping, closest-action visibility attribution) — or
``"matcher"`` — the definitional sparse-spot matcher below (rounding frame
mapping, no dense-vector collision collapse; identical AP recipe). The two
agree exactly on well-separated, truncation-safe spot positions
(tests/test_eval_official.py pins both the agreement and each documented
divergence).
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

from ball_action_spotting_torch.domains.base import Domain

METRIC_DELTAS = {
    "loose": np.arange(12) * 5 + 5,
    "tight": np.arange(5) + 1,
    "at1": np.array([1]),
    "at2": np.array([2]),
    "at3": np.array([3]),
    "at4": np.array([4]),
    "at5": np.array([5]),
}


def spots_from_labels(
    labels: dict, domain: Domain, half: int, framerate: float,
    visibility: Optional[str] = None,
) -> dict[str, list[int]]:
    """Ground-truth spot frames per class for one half, from a label JSON
    (the position-ms → frame mapping of ``label2vector``). ``visibility``
    restricts to annotations with that visibility value ("visible" /
    "not shown") for the split metrics."""
    out: dict[str, list[int]] = {cls: [] for cls in domain.classes}
    for ann in labels["annotations"]:
        ann_half = int(ann["gameTime"].split(" - ")[0])
        if ann_half != half:
            continue
        if visibility is not None and ann.get("visibility") != visibility:
            continue
        label = ann["label"]
        label = domain.merged_classes.get(label, label)
        if label not in out:
            continue
        frame = int(round(float(ann["position"]) / 1000 * framerate))
        out[label].append(frame)
    return out


def spots_from_predictions(
    predictions: dict, domain: Domain, half: int, framerate: float
) -> dict[str, list[tuple[int, float]]]:
    """(frame, confidence) prediction spots per class for one half."""
    inverse_output_map = {v: k for k, v in domain.output_class_map.items()}
    out: dict[str, list[tuple[int, float]]] = {cls: [] for cls in domain.classes}
    for pred in predictions["predictions"]:
        if int(pred["half"]) != half:
            continue
        label = inverse_output_map.get(pred["label"], pred["label"])
        label = domain.merged_classes.get(label, label)
        if label not in out:
            continue
        frame = int(round(float(pred["position"]) / 1000 * framerate))
        out[label].append((frame, float(pred["confidence"])))
    return out


def match_spots(
    gt_frames: Sequence[int],
    pred_spots: Sequence[tuple[int, float]],
    window: float,
) -> np.ndarray:
    """One-to-one GT↔prediction matching within ±window frames.

    Returns an array (n_preds, 2) of [confidence, matched 0/1]. Ground truths
    are visited in temporal order; each claims the highest-confidence
    still-unmatched prediction in its window.
    """
    preds = sorted(pred_spots)  # by frame
    result = np.zeros((len(preds), 2))
    for i, (frame, conf) in enumerate(preds):
        result[i, 0] = conf
    taken = np.zeros(len(preds), dtype=bool)
    for gt in sorted(gt_frames):
        best, best_conf = -1, -np.inf
        for i, (frame, conf) in enumerate(preds):
            if frame < gt - window:
                continue
            if frame > gt + window:
                break
            if not taken[i] and conf > best_conf:
                best, best_conf = i, conf
        if best >= 0:
            taken[best] = True
            result[best, 1] = 1.0
    return result


def average_precision(detections: np.ndarray, total_gt: int,
                      num_thresholds: int = 200) -> float:
    """AP over a [confidence, matched] array using the official numeric
    recipe: 200 confidence thresholds, 0/0 -> 0 precision/recall, 11-point
    interpolation — delegated to ``eval/official_map.py`` so the two
    evaluator paths cannot drift numerically. A class with no ground truth
    scores 0 (it stays in the class mean, as in the official evaluator)."""
    from ball_action_spotting_torch.eval.official_map import (
        _ap_from_curve,
        _threshold_curves,
    )

    if not len(detections):
        return 0.0
    precision, recall = _threshold_curves(detections, total_gt,
                                          num_thresholds)
    return _ap_from_curve(precision, recall)


def average_map(
    games_gt: Sequence[Mapping[str, Sequence[int]]],
    games_pred: Sequence[Mapping[str, Sequence[tuple[int, float]]]],
    classes: Sequence[str],
    framerate: float,
    deltas: np.ndarray,
) -> tuple[float, list[float]]:
    """Average over tolerances of mean-over-classes AP.

    games_gt / games_pred are per-half dicts class → spots (aligned lists).
    """
    maps = []
    per_class_all = []
    for delta in deltas:
        window = delta * framerate / 2
        per_class = []
        for cls in classes:
            dets = []
            total_gt = 0
            for gt_half, pred_half in zip(games_gt, games_pred):
                gt = gt_half.get(cls, [])
                pred = pred_half.get(cls, [])
                total_gt += len(gt)
                if pred:
                    dets.append(match_spots(gt, pred, window))
            det_arr = (
                np.concatenate(dets, axis=0) if dets else np.zeros((0, 2))
            )
            per_class.append(average_precision(det_arr, total_gt))
        per_class_all.append(per_class)
        maps.append(np.mean(per_class))
    a_map = float(np.mean(maps))
    a_map_per_class = list(np.mean(np.asarray(per_class_all), axis=0))
    return a_map, a_map_per_class


def read_game_json(root: Path, relpath: str) -> dict:
    """Read ``<root>/<relpath>`` where ``root`` is a directory OR a zip
    archive. The reference evaluator accepts zipped label sets and zipped
    prediction sets via ``LoadJsonFromZip`` (reference ``src/
    evaluate.py:54-82``); this is the equivalent for both loaders here.
    Zip members may be stored with or without a leading ``./``."""
    root = Path(root)
    if root.is_file() and zipfile.is_zipfile(root):
        with zipfile.ZipFile(root) as zf:
            names = set(zf.namelist())
            for cand in (relpath, f"./{relpath}"):
                if cand in names:
                    return json.loads(zf.read(cand))
            raise FileNotFoundError(f"{relpath!r} not found in archive {root}")
    return json.loads((root / relpath).read_text())


def evaluate_games(
    soccernet_dir: Path,
    predictions_dir: Path,
    games: Sequence[str],
    domain: Domain,
    metric: str = "at1",
    framerate: Optional[float] = None,
    prediction_file: str = "results_spotting.json",
    algorithm: str = "official",
) -> dict:
    """Directory-level evaluation matching the reference evaluate CLI
    (reference ``scripts/ball_action/evaluate.py:17-38``).

    ``algorithm="official"`` reproduces the SoccerNet package pipeline
    exactly (the reference's numbers); ``"matcher"`` uses the definitional
    sparse-spot path in this module (see module docstring for divergences).
    """
    assert algorithm in ("official", "matcher"), algorithm
    framerate = framerate or domain.video_fps
    deltas = METRIC_DELTAS[metric]

    loaded = []
    any_visibility = False
    for game in games:
        labels = read_game_json(soccernet_dir, f"{game}/{domain.label_file}")
        any_visibility = any_visibility or any(
            "visibility" in a for a in labels["annotations"]
        )
        preds = read_game_json(predictions_dir, f"{game}/{prediction_file}")
        loaded.append((labels, preds))

    results = {
        "a_mAP": None,
        "a_mAP_per_class": None,
        "a_mAP_visible": None,
        "a_mAP_per_class_visible": None,
        "a_mAP_unshown": None,
        "a_mAP_per_class_unshown": None,
        "metric": metric,
        "games": list(games),
    }

    if algorithm == "official":
        from ball_action_spotting_torch.eval.official_map import (
            average_map_official,
            closest_vector,
            label_vectors,
            prediction_vectors,
        )

        targets, detections, closests = [], [], []
        for labels, preds in loaded:
            gt_halves = label_vectors(labels, domain, framerate)
            pred_halves = prediction_vectors(preds, domain, framerate)
            for half in domain.halves:
                targets.append(gt_halves[half])
                detections.append(pred_halves[half])
                closests.append(closest_vector(gt_halves[half]))
        (a_map, per_class, a_map_vis, per_class_vis,
         a_map_uns, per_class_uns) = average_map_official(
            targets, detections, closests, framerate, deltas
        )
        results["a_mAP"] = a_map
        results["a_mAP_per_class"] = per_class
        # reference gates the splits on label version (src/evaluate.py:144-147)
        if any_visibility:
            results["a_mAP_visible"] = a_map_vis
            results["a_mAP_per_class_visible"] = per_class_vis
            results["a_mAP_unshown"] = a_map_uns
            results["a_mAP_per_class_unshown"] = per_class_uns
        return results

    games_gt, games_pred = [], []
    games_gt_visible, games_gt_unshown = [], []
    for labels, preds in loaded:
        for half in domain.halves:
            games_gt.append(spots_from_labels(labels, domain, half, framerate))
            games_gt_visible.append(
                spots_from_labels(labels, domain, half, framerate, "visible")
            )
            games_gt_unshown.append(
                spots_from_labels(labels, domain, half, framerate, "not shown")
            )
            games_pred.append(spots_from_predictions(preds, domain, half, framerate))

    a_map, per_class = average_map(
        games_gt, games_pred, domain.classes, framerate, deltas
    )
    results["a_mAP"] = a_map
    results["a_mAP_per_class"] = per_class
    if any_visibility:
        for key, gt in (("visible", games_gt_visible), ("unshown", games_gt_unshown)):
            split_map, split_per_class = average_map(
                gt, games_pred, domain.classes, framerate, deltas
            )
            results[f"a_mAP_{key}"] = split_map
            results[f"a_mAP_per_class_{key}"] = split_per_class
    return results
