"""Action-domain evaluation CLI: tight average-mAP over one split (port of
the JAX package's ``scripts/action/evaluate.py``).

    python -m ball_action_spotting_torch.cli.action_evaluate --experiment NAME \\
        [--algorithm official|matcher] [--split val]

Scores ``data/action/predictions/NAME/SPLIT`` against each game's
``Labels-v2.json`` (metric "tight": tolerances 1-5 s, 25 fps; the visible and
unshown splits too), writes ``evaluate_results.json`` there.
"""

from __future__ import annotations

import argparse
import json

from ball_action_spotting_torch.cli.action_predict import SPLITS
from ball_action_spotting_torch.domains import action
from ball_action_spotting_torch.eval.soccernet_map import evaluate_games

METRIC = "tight"


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", required=True, type=str)
    parser.add_argument("--algorithm", default="official", choices=["official", "matcher"],
                        help="official SoccerNet average_mAP (default) or the one-to-one "
                             "matcher path")
    parser.add_argument("--split", default="val", choices=SPLITS)
    return parser.parse_args(argv)


def evaluate_split(experiment: str, split: str, algorithm: str = "official") -> dict:
    domain = action.DOMAIN
    prediction_dir = domain.predictions_dir / experiment / split
    results = evaluate_games(domain.soccernet_dir, prediction_dir,
                             action.load_games_list(split), domain, metric=METRIC,
                             algorithm=algorithm)
    out_path = prediction_dir / "evaluate_results.json"
    out_path.write_text(json.dumps(results, indent=4))
    print(f"a_mAP ({METRIC}): {results['a_mAP']:.4f} → {out_path}")
    return results


def main(argv=None) -> None:
    args = parse_arguments(argv)
    evaluate_split(args.experiment, args.split, args.algorithm)


if __name__ == "__main__":
    main()
