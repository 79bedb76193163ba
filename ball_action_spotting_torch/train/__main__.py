"""Ball-action training CLI: the 7-fold cross-validation loop (port of
the JAX package's ``scripts/ball_action/train.py``).

    python -m ball_action_spotting_torch.train --experiment NAME \
        [--folds 0,3] [--seed 0] [--device cuda]
    torchrun --nproc_per_node N -m ball_action_spotting_torch.train --experiment NAME ...

Loads ``NAME`` from the port's configs (``paths.configs_dir()``), snapshots
the config into ``data/ball_action/experiments/NAME`` and trains each fold
into ``fold_K`` there, resolving each stage's pretrain checkpoint: the best
``.ckpt`` of an action experiment (stage 3) or of the same fold of a ball
experiment (stage 4). Under ``torchrun`` the processes join one process group
(NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and train data
parallel over the config's global ``batch_size``; only the primary process
writes the experiment's files.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from pprint import pprint

import torch

from ball_action_spotting_torch.domains import action, ball
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.train.checkpoint import snapshot_experiment
from ball_action_spotting_torch.train.pipeline import resolve_stage_pretrain, train_stage
from ball_action_spotting_torch.utils.experiments import load_experiment_config


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--folds", default="all", type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    device = args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # launched by torchrun
        on_cpu = torch.device(device).type == "cpu"
        multihost.initialize(backend="gloo" if on_cpu else "nccl")
        if not on_cpu:
            device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
    domain = ball.DOMAIN
    print("Experiment:", args.experiment)
    config = load_experiment_config(args.experiment, domain)
    pprint(config, sort_dicts=False)

    experiments_dir = domain.experiments_dir / args.experiment
    if multihost.is_primary():
        snapshot_experiment(experiments_dir, config,
                            extra_files={"train.py": Path(__file__).read_text()})
    folds = ball.folds if args.folds == "all" else [int(f) for f in args.folds.split(",")]
    for fold in folds:
        train_folds = sorted(set(ball.folds) - {fold})
        val_games = ball.fold2games[fold]
        train_games = [g for f in train_folds for g in ball.fold2games[f]]
        print(f"Val fold: {fold}, train folds: {train_folds}")
        print(f"Val games: {val_games}, train games: {train_games}")
        pretrain = resolve_stage_pretrain(config, domain, fold, action.DOMAIN)
        best = train_stage(config, domain, experiments_dir / f"fold_{fold}", train_games,
                           val_games, game2fold=ball.game2fold, pretrain_variables=pretrain,
                           seed=args.seed + fold, device=device)
        print(f"Fold {fold} best: {best}")


if __name__ == "__main__":
    main()
