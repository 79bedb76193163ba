"""Spotting-results and raw-prediction persistence (copy of the JAX
package's ``core/spotting.py`` write side). ``results_spotting.json`` is the
SoccerNet submission contract; field layout and ordering match the JAX
writer exactly."""

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
