"""Whole-experiment prediction pipeline (port of the JAX package's
``predict/pipeline.py``): per game and half, raw per-frame sigmoid
predictions saved as npz, then the peak postprocess, then the game's
``results_spotting.json``. The engine is selectable: the chunked engine
for offline throughput (default) or the per-frame streaming engine.
``predict_games_fused`` runs every fold's model in one pass over each video
(``predict/fused.py``) and writes the per-fold loop's files.
``data_parallel=N`` spreads each chunk over N devices and ``fold_parallel=N``
the folds (``parallel/mesh.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ball_action_spotting_torch.core.annotations import cached_video_info
from ball_action_spotting_torch.core.postprocess import raw_predictions_to_actions
from ball_action_spotting_torch.core.spotting import (
    load_raw_predictions,
    save_raw_predictions,
    write_game_spotting_results,
)
from ball_action_spotting_torch.data.video import open_source
from ball_action_spotting_torch.domains.base import Domain
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
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


def device_grid(n_data: int, n_model: int, device: str | torch.device = "cuda"):
    """A (n_data, n_model) grid of consecutive CUDA devices from ``device``
    on (``cuda`` is the current device), or of the CPU repeated where
    ``device`` is the CPU."""
    device = torch.device(device)
    count = n_data * n_model
    if device.type == "cpu":
        return make_mesh(n_data, n_model, ["cpu"] * count)
    first = torch.cuda.current_device() if device.index is None else device.index
    if first + count > torch.cuda.device_count():
        raise ValueError(f"a ({n_data}, {n_model}) grid from {device} needs cuda:{first} to "
                         f"cuda:{first + count - 1}; {torch.cuda.device_count()} are visible")
    return make_mesh(n_data, n_model, [torch.device("cuda", first + i) for i in range(count)])


def predict_games(model_path: Optional[Path], games: Sequence[str], domain: Domain,
                  prediction_dir: Path, engine: str = "chunked", tta: bool = False,
                  use_saved: bool = False, resolution: str = "720p",
                  video_info_fn=None, device: str = "cuda", data_parallel: int = 1,
                  **predictor_kwargs) -> None:
    """Predict every game with one model through ``engine``;
    ``predictor_kwargs`` go to it (``dtype``, ``dw3d_use_kernel``, the
    chunked engine's ``chunk_size`` ...). ``data_parallel > 1`` spreads the
    chunked engine's chunks over a (data_parallel, 1) device grid, equal to
    one device."""
    predictor = None
    if not use_saved:
        if data_parallel > 1:
            if engine != "chunked":
                raise ValueError("data_parallel>1 requires the chunked engine")
            predictor_kwargs["mesh"] = device_grid(data_parallel, 1, device)
        predictor = make_predictor(model_path, engine=engine, tta=tta, device=device,
                                   **predictor_kwargs)
    for game in games:
        print("Predict game:", game)
        predict_game(predictor, game, domain, prediction_dir, resolution=resolution,
                     use_saved=use_saved, video_info_fn=video_info_fn)


def predict_games_fused(fold2model_path: dict, games: Sequence[str], domain: Domain,
                        fold2prediction_dir: dict, tta: bool = False,
                        resolution: str = "720p", video_info_fn=None,
                        data_parallel: int = 1, fold_parallel: int = 1,
                        device: str = "cuda", **predictor_kwargs) -> None:
    """Every fold's model over the same games with one decode and upload
    per video (``FusedFoldsPredictor``). Writes each fold's raw npz and
    spotting JSON in the layout of the per-fold ``predict_games`` loop, so
    the ensemble CLI sees no difference. ``data_parallel=N`` spreads each
    chunk over an (N, 1) grid, ``fold_parallel=N`` the folds over a (1, N)
    grid; not both."""
    folds = sorted(fold2model_path)
    if sorted(fold2prediction_dir) != folds:
        raise ValueError("fold2model_path and fold2prediction_dir must cover the same folds")
    if data_parallel > 1 and fold_parallel > 1:
        raise ValueError("data_parallel and fold_parallel are mutually exclusive "
                         "(share the frames or the folds)")
    if data_parallel > 1:
        predictor_kwargs["mesh"] = device_grid(data_parallel, 1, device)
    elif fold_parallel > 1:
        predictor_kwargs.update(mesh=device_grid(1, fold_parallel, device),
                                fold_parallel=True)
    predictor = FusedFoldsPredictor([fold2model_path[f] for f in folds], tta=tta,
                                    device=device, **predictor_kwargs)
    video_info_fn = video_info_fn or cached_video_info
    for game in games:
        print("Predict game (fused folds):", game)
        game_dir = domain.soccernet_dir / game
        fold2half_actions = {fold: {} for fold in folds}
        for half in domain.halves:
            video_path = game_dir / f"{half}_{resolution}.mkv"
            info = video_info_fn(str(video_path))
            source = open_source(dict(video_path=str(video_path), game=game, half=half,
                                      **info, frame_index2action={}))
            try:
                frame_indexes, raw = predictor.predict_video(
                    iter_source_frames(source), info["frame_count"])  # (T, folds, classes)
            finally:
                source.close()
            for i, fold in enumerate(folds):
                game_pred_dir = fold2prediction_dir[fold] / game
                game_pred_dir.mkdir(parents=True, exist_ok=True)
                save_raw_predictions(game_pred_dir / f"{half}_raw_predictions.npz",
                                     np.asarray(frame_indexes), raw[:, i])
                fold2half_actions[fold][half] = raw_predictions_to_actions(
                    frame_indexes, raw[:, i], domain)
        for fold in folds:
            write_game_spotting_results(fold2half_actions[fold], game,
                                        fold2prediction_dir[fold], domain)
