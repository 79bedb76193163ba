"""Ball-action prediction CLI: per-fold CV or challenge whole-video
inference, hflip TTA on, with the chunked engine (default) or the per-frame
streaming engine.

    python -m ball_action_spotting_torch.predict --experiment NAME \\
        [--folds 0,1] [--challenge] [--use_saved_predictions] \\
        [--engine chunked|streaming] [--data_parallel N] \\
        [--fused [--fold_parallel N]] [--device cuda] [--trace_dir DIR]

Reads the best ``.ckpt`` of ``data/ball_action/experiments/NAME/fold_K``
(the files the JAX training CLI writes) and writes the raw npz and
``results_spotting.json`` under ``data/ball_action/predictions/NAME/{cv,
challenge}/fold_K``, as the JAX predict CLI does. ``--fused`` (challenge
only) runs all the folds' models in one pass over each video
(``predict/fused.py``); ``--data_parallel N`` spreads each chunk over N
devices, ``--fold_parallel N`` (with ``--fused``) the folds.
``--trace_dir DIR`` runs the prediction under ``utils/profiling.py::
device_trace``: a Chrome trace of the run and, beside it, the tracer's
spans and counters (``predict.*``) as JSON.
"""

from __future__ import annotations

import argparse
import contextlib

from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.predict.pipeline import (
    ENGINES,
    predict_games,
    predict_games_fused,
)
from ball_action_spotting_torch.train.checkpoint import get_best_checkpoint_path
from ball_action_spotting_torch.utils.profiling import device_trace

RESOLUTION = "720p"
TTA = True


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--folds", default="all", type=str)
    parser.add_argument("--challenge", action="store_true")
    parser.add_argument("--use_saved_predictions", action="store_true")
    parser.add_argument("--engine", default="chunked", choices=ENGINES)
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="spread the chunked engine over N devices (equal to one)")
    parser.add_argument("--fused", action="store_true",
                        help="challenge only: every fold's model in one pass over each "
                             "video, decoded and uploaded once (predict/fused.py); the "
                             "files are the per-fold loop's")
    parser.add_argument("--fold_parallel", type=int, default=1,
                        help="with --fused: the folds over N devices (not with "
                             "--data_parallel)")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--trace_dir", default=None, type=str,
                        help="trace the run into this directory: a Chrome trace and the "
                             "program's spans and counters (JSON)")
    return parser.parse_args(argv)


def predict_fold(args, fold: int, domain) -> None:
    experiment_dir = domain.experiments_dir / args.experiment / f"fold_{fold}"
    model_path = get_best_checkpoint_path(experiment_dir)
    if model_path is None and not args.use_saved_predictions:
        raise FileNotFoundError(f"No checkpoint in {experiment_dir}")
    print(f"Predict fold {fold}, model {model_path}")
    split = "challenge" if args.challenge else "cv"
    games = ball.challenge_games if args.challenge else ball.fold2games[fold]
    prediction_dir = domain.predictions_dir / args.experiment / split / f"fold_{fold}"
    predict_games(model_path, games, domain, prediction_dir, engine=args.engine, tta=TTA,
                  use_saved=args.use_saved_predictions, resolution=RESOLUTION,
                  device=args.device, data_parallel=args.data_parallel)


def predict_challenge_fused(args, folds, domain) -> None:
    fold2model, fold2dir = {}, {}
    for fold in folds:
        experiment_dir = domain.experiments_dir / args.experiment / f"fold_{fold}"
        model_path = get_best_checkpoint_path(experiment_dir)
        if model_path is None:
            raise FileNotFoundError(f"No checkpoint in {experiment_dir}")
        fold2model[fold] = model_path
        fold2dir[fold] = domain.predictions_dir / args.experiment / "challenge" / f"fold_{fold}"
    print(f"Fused challenge predict, folds {folds}, models {fold2model}")
    predict_games_fused(fold2model, ball.challenge_games, domain, fold2dir, tta=TTA,
                        resolution=RESOLUTION, data_parallel=args.data_parallel,
                        fold_parallel=args.fold_parallel, device=args.device)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    with device_trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext():
        run(args)


def run(args) -> None:
    folds = ball.folds if args.folds == "all" else [int(f) for f in args.folds.split(",")]
    if args.fold_parallel > 1 and not args.fused:
        raise ValueError("--fold_parallel shards the fused engine's folds; add --fused "
                         "(or use --data_parallel)")
    if args.fused:
        if not args.challenge:
            raise ValueError("--fused requires --challenge (CV folds predict disjoint "
                             "games; there is no shared decode to fuse)")
        if args.use_saved_predictions:
            raise ValueError("--fused re-runs the models; drop --use_saved_predictions")
        if args.engine != "chunked":
            raise ValueError("--fused requires the chunked engine")
        predict_challenge_fused(args, folds, ball.DOMAIN)
        return
    for fold in folds:
        predict_fold(args, fold, ball.DOMAIN)


if __name__ == "__main__":
    main()
