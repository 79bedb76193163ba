"""Action-domain prediction CLI: one split, hflip TTA off (port of the JAX
package's ``scripts/action/predict.py``).

    python -m ball_action_spotting_torch.cli.action_predict --experiment NAME \\
        [--split train|val|test|challenge] [--use_saved_predictions] \\
        [--engine chunked|streaming] [--data_parallel N] [--device cuda]

Predicts every game of the split (``domains/action.py::load_games_list``)
with the best ``.ckpt`` of ``data/action/experiments/NAME`` and writes the raw
npz and ``results_spotting.json`` ("Card" written back as "Yellow card")
under ``data/action/predictions/NAME/SPLIT``. ``--data_parallel N`` spreads
the chunked engine's chunks over N devices, equal to one device.
"""

from __future__ import annotations

import argparse

import torch

from ball_action_spotting_torch.domains import action
from ball_action_spotting_torch.predict.pipeline import ENGINES, predict_games
from ball_action_spotting_torch.train.checkpoint import get_best_checkpoint_path

RESOLUTION = "720p"
TTA = False
SPLITS = ["train", "val", "test", "challenge"]


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--split", default="val", choices=SPLITS)
    parser.add_argument("--use_saved_predictions", action="store_true")
    parser.add_argument("--engine", default="chunked", choices=ENGINES)
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="spread the chunked engine over N devices (equal to one)")
    parser.add_argument("--device", default="cuda", type=str)
    return parser.parse_args(argv)


def predict_split(experiment: str, split: str, use_saved: bool = False,
                  device: str | torch.device = "cuda", engine: str = "chunked",
                  **predictor_kwargs) -> None:
    """Predict one split; ``predictor_kwargs`` go to the engine
    (``dtype``, ``dw3d_use_kernel``, the chunked engine's ``chunk_size`` ...)."""
    domain = action.DOMAIN
    experiment_dir = domain.experiments_dir / experiment
    model_path = get_best_checkpoint_path(experiment_dir)
    if model_path is None and not use_saved:
        raise FileNotFoundError(f"No checkpoint in {experiment_dir}")
    predict_games(model_path, action.load_games_list(split), domain,
                  domain.predictions_dir / experiment / split, engine=engine, tta=TTA,
                  use_saved=use_saved,
                  resolution=RESOLUTION, device=device, **predictor_kwargs)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    predict_split(args.experiment, args.split, args.use_saved_predictions, args.device,
                  args.engine, data_parallel=args.data_parallel)


if __name__ == "__main__":
    main()
