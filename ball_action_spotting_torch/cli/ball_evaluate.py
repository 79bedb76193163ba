"""Ball-action evaluation CLI: mAP@1 over CV fold predictions (port of the
JAX package's ``scripts/ball_action/evaluate.py``).

    python -m ball_action_spotting_torch.cli.ball_evaluate --experiment NAME \\
        [--algorithm official|matcher] [--folds 0,3]

Scores ``data/ball_action/predictions/NAME/cv/fold_K`` against each fold's
``Labels-ball.json`` (metric "at1", 25 fps), writes
``evaluate_results.json`` there and prints the mean over the folds.
"""

from __future__ import annotations

import argparse
import json

from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.eval.soccernet_map import evaluate_games

METRIC = "at1"


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--algorithm", default="official", choices=["official", "matcher"],
                        help="official SoccerNet average_mAP (default) or the one-to-one "
                             "matcher path")
    parser.add_argument("--folds", default="all", type=str)
    return parser.parse_args(argv)


def evaluate_fold(experiment: str, fold: int, algorithm: str = "official") -> dict:
    domain = ball.DOMAIN
    prediction_dir = domain.predictions_dir / experiment / "cv" / f"fold_{fold}"
    results = evaluate_games(domain.soccernet_dir, prediction_dir, ball.fold2games[fold],
                             domain, metric=METRIC, algorithm=algorithm)
    out_path = prediction_dir / "evaluate_results.json"
    out_path.write_text(json.dumps(results, indent=4))
    print(f"Fold {fold}: a_mAP {results['a_mAP']:.4f} "
          f"per class {results['a_mAP_per_class']} → {out_path}")
    return results


def main(argv=None) -> None:
    args = parse_arguments(argv)
    folds = ball.folds if args.folds == "all" else [int(f) for f in args.folds.split(",")]
    fold_results = [evaluate_fold(args.experiment, fold, args.algorithm) for fold in folds]
    mean_map = sum(r["a_mAP"] for r in fold_results) / len(fold_results)
    print(f"CV mean a_mAP@1: {mean_map:.4f}")


if __name__ == "__main__":
    main()
