"""Spotting-results and raw-prediction persistence, and the ensemble blend
(copy of the JAX package's ``core/spotting.py``). ``results_spotting.json``
is the SoccerNet submission contract; field layout and ordering match the
JAX writer exactly."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from ball_action_spotting_torch.domains.base import Domain

ClassActions = Mapping[str, tuple[Sequence[int], Sequence[float]]]


def frame_index_to_position_ms(frame_index: int, fps: float) -> int:
    return round(frame_index / fps * 1000)


def game_spotting_results(
    half2class_actions: Mapping[int, ClassActions], game: str, domain: Domain
) -> dict:
    """Build the results_spotting dict for one game."""
    predictions = []
    for half, class_actions in half2class_actions.items():
        for cls, (frame_indexes, confidences) in class_actions.items():
            out_cls = domain.output_class_map.get(cls, cls)
            for frame_index, confidence in zip(frame_indexes, confidences):
                position = frame_index_to_position_ms(frame_index, domain.video_fps)
                seconds = int(frame_index / domain.video_fps)
                predictions.append(
                    {
                        "gameTime": f"{half} - {seconds // 60:02}:{seconds % 60:02}",
                        "label": out_cls,
                        "position": str(position),
                        "half": str(half),
                        "confidence": str(confidence),
                    }
                )
    predictions.sort(key=lambda p: (int(p["half"]), int(p["position"])))
    return {"UrlLocal": game, "predictions": predictions}


def write_game_spotting_results(
    half2class_actions: Mapping[int, ClassActions],
    game: str,
    prediction_dir: Path,
    domain: Domain,
) -> Path:
    """Write results_spotting.json (+ postprocess params snapshot) for one
    game under ``prediction_dir/game/``."""
    game_dir = Path(prediction_dir) / game
    game_dir.mkdir(parents=True, exist_ok=True)

    results = game_spotting_results(half2class_actions, game, domain)
    results_path = game_dir / "results_spotting.json"
    results_path.write_text(json.dumps(results, indent=4))
    (game_dir / "postprocess_params.json").write_text(
        json.dumps(domain.postprocess.as_dict(), indent=4)
    )
    return results_path


def read_game_spotting_results(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def save_raw_predictions(
    path: Path, frame_indexes: np.ndarray, raw_predictions: np.ndarray
) -> None:
    """Save a half's per-frame raw scores as npz (keys ``frame_indexes`` and
    ``raw_predictions``, as the JAX pipeline writes them)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        str(path),
        frame_indexes=np.asarray(frame_indexes),
        raw_predictions=np.asarray(raw_predictions),
    )


def load_raw_predictions(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with np.load(str(path)) as npz:
        return npz["frame_indexes"], npz["raw_predictions"]


def blend_raw_predictions(
    loaded: Sequence[tuple[np.ndarray, np.ndarray]],
) -> tuple[np.ndarray, np.ndarray]:
    """Arithmetic-mean ensemble of raw-prediction arrays over the UNION of
    member frame ranges (reference ``scripts/ball_action/ensemble.py:18-35``):
    members are summed into a dense timeline and divided by the member
    count, so frames a member does not cover contribute zeros — exactly the
    reference's accumulation (lines 28-32). Members with different windows
    (e.g. a 15-frame stage-3 and a 33-frame stage-4 model) therefore blend
    over ``[min(all indexes), max(all indexes)]``.

    Deviation note: the reference's tail (lines 33-34) reuses the loop
    variable ``frame_indexes`` after the loop, slicing/asserting against the
    LAST member's range — which crashes on mixed-range ensembles (its real
    recipe only blends same-window members, where this is equivalent to the
    union). We return the union range, which is identical for same-window
    members and well-defined otherwise."""
    all_indexes = np.concatenate([fi for fi, _ in loaded])
    lo, hi = int(all_indexes.min()), int(all_indexes.max())
    unique = np.unique(all_indexes)
    if len(unique) != hi - lo + 1:
        # disjoint coverage = a stale/misaligned member, not a window-size
        # difference (overlapping contiguous ranges always union to a
        # contiguous range); silently zero-filling the gap would dilute
        # every score — and the reference's assert would fail here too
        raise ValueError(
            "Ensemble members cover disjoint frame ranges "
            f"({len(unique)} covered frames in span [{lo}, {hi}])"
        )
    # same-extent members over one video must cover IDENTICAL ranges (the
    # range is fully determined by video length + window geometry): equal
    # extents with shifted endpoints mean a stale/shifted member, which
    # would otherwise blend silently and dilute edge scores. Genuine
    # mixed-window ensembles (15- vs 33-frame stages) differ in extent.
    spans = {(int(fi.min()), int(fi.max())) for fi, _ in loaded}
    extents = {b - a for a, b in spans}
    if len(extents) == 1 and len(spans) > 1:
        raise ValueError(
            f"Same-window ensemble members cover misaligned frame ranges: "
            f"{sorted(spans)}"
        )
    num_classes = loaded[0][1].shape[1]
    dense = np.zeros((hi - lo + 1, num_classes), dtype=np.float64)
    for fi, rp in loaded:
        dense[np.asarray(fi) - lo] += rp
    dense /= len(loaded)
    return np.arange(lo, hi + 1), dense
