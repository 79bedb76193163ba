"""Action-domain training CLI: fixed train/val splits, no folds (port of the
JAX package's ``scripts/action/train.py``).

    python -m ball_action_spotting_torch.cli.action_train --experiment NAME \\
        [--seed 0] [--device cuda]

Loads ``NAME`` from the port's configs (``paths.configs_dir()/action``),
reads the split lists with ``domains/action.py::load_games_list`` (JSON files
in ``$BAS_TPU_ACTION_SPLITS``), snapshots the config and trains into
``data/action/experiments/NAME``, keeping a checkpoint of every train epoch
(``max_saves`` is the sum of the train stages' epochs). Its best ``.ckpt``
is what the ball stage-3 recipe (``ball_tuning_001``) starts from.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from pprint import pprint

import torch

from ball_action_spotting_torch.domains import action
from ball_action_spotting_torch.train.checkpoint import snapshot_experiment
from ball_action_spotting_torch.train.pipeline import train_stage
from ball_action_spotting_torch.utils.experiments import load_experiment_config


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    return parser.parse_args(argv)


def train_experiment(experiment: str, config: dict, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """Train ``config`` on the action splits into the experiment dir; returns
    the best epoch's metrics."""
    domain = action.DOMAIN
    experiments_dir = domain.experiments_dir / experiment
    snapshot_experiment(experiments_dir, config,
                        extra_files={"train.py": Path(__file__).read_text()})
    train_games = action.load_games_list("train")
    val_games = action.load_games_list("val")
    print(f"{len(train_games)} train games, {len(val_games)} val games")
    max_saves = sum(n for n, stage in zip(config["num_epochs"], config["stages"])
                    if stage == "train")
    return train_stage(config, domain, experiments_dir, train_games, val_games, seed=seed,
                       max_saves=max_saves, device=device)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    print("Experiment:", args.experiment)
    config = load_experiment_config(args.experiment, action.DOMAIN)
    pprint(config, sort_dicts=False)
    best = train_experiment(args.experiment, config, seed=args.seed, device=args.device)
    print(f"Best: {best}")


if __name__ == "__main__":
    main()
