"""Whole-experiment prediction pipeline (port of the JAX package's
``predict/pipeline.py``, single device): per game and half, raw per-frame
sigmoid predictions saved as npz, then the peak postprocess, then the game's
``results_spotting.json``. The engine is selectable: the chunked engine
for offline throughput (default) or the per-frame streaming engine. Not
ported yet: the multi-device options and the fused multi-fold engine."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ball_action_spotting_torch.core.annotations import cached_video_info
from ball_action_spotting_torch.core.postprocess import raw_predictions_to_actions
from ball_action_spotting_torch.core.spotting import (
    load_raw_predictions,
    save_raw_predictions,
    write_game_spotting_results,
)
from ball_action_spotting_torch.data.video import open_source
from ball_action_spotting_torch.domains.base import Domain
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    PredictorBase,
    StreamingPredictor,
    get_raw_predictions,
    iter_source_frames,
)

ENGINES = ("chunked", "streaming")


def make_predictor(model_path: Path, engine: str = "chunked", tta: bool = False,
                   **kwargs) -> PredictorBase:
    if engine == "chunked":
        return ChunkedVideoPredictor(model_path, tta=tta, **kwargs)
    if engine == "streaming":
        return StreamingPredictor(model_path, tta=tta, **kwargs)
    raise ValueError(f"Unknown engine {engine!r}")


def predict_video(predictor: Optional[PredictorBase], video_data: dict,
                  raw_predictions_path: Path, use_saved: bool = False):
    """→ (frame_indexes, raw) for one half; saves or loads the raw npz."""
    if use_saved:
        if not raw_predictions_path.exists():
            raise FileNotFoundError(
                f"--use_saved_predictions set but {raw_predictions_path} is "
                "missing; run predict without the flag first")
        return load_raw_predictions(raw_predictions_path)
    source = open_source(video_data)
    try:
        if isinstance(predictor, ChunkedVideoPredictor):
            frame_indexes, raw = predictor.predict_video(
                iter_source_frames(source), video_data["frame_count"])
        else:
            frame_indexes, raw = get_raw_predictions(
                predictor, source, video_data["frame_count"])
    finally:
        source.close()
    save_raw_predictions(raw_predictions_path, np.asarray(frame_indexes), raw)
    print("Raw predictions saved to", raw_predictions_path)
    return frame_indexes, raw


def predict_game(predictor: Optional[PredictorBase], game: str, domain: Domain,
                 prediction_dir: Path, resolution: str = "720p",
                 use_saved: bool = False, video_info_fn=None) -> None:
    video_info_fn = video_info_fn or cached_video_info
    game_dir = domain.soccernet_dir / game
    game_prediction_dir = prediction_dir / game
    game_prediction_dir.mkdir(parents=True, exist_ok=True)
    half2class_actions = {}
    for half in domain.halves:
        video_path = game_dir / f"{half}_{resolution}.mkv"
        info = video_info_fn(str(video_path))
        video_data = dict(video_path=str(video_path), game=game, half=half, **info,
                          frame_index2action={})
        raw_path = game_prediction_dir / f"{half}_raw_predictions.npz"
        frame_indexes, raw = predict_video(predictor, video_data, raw_path, use_saved)
        half2class_actions[half] = raw_predictions_to_actions(frame_indexes, raw, domain)
    write_game_spotting_results(half2class_actions, game, prediction_dir, domain)


def predict_games(model_path: Optional[Path], games: Sequence[str], domain: Domain,
                  prediction_dir: Path, engine: str = "chunked", tta: bool = False,
                  use_saved: bool = False, resolution: str = "720p",
                  video_info_fn=None, device: str = "cuda", **predictor_kwargs) -> None:
    """Predict every game with one model through ``engine``;
    ``predictor_kwargs`` go to it (``dtype``, ``dw3d_use_kernel``, the
    chunked engine's ``chunk_size`` ...)."""
    predictor = None
    if not use_saved:
        predictor = make_predictor(model_path, engine=engine, tta=tta, device=device,
                                   **predictor_kwargs)
    for game in games:
        print("Predict game:", game)
        predict_game(predictor, game, domain, prediction_dir, resolution=resolution,
                     use_saved=use_saved, video_info_fn=video_info_fn)
