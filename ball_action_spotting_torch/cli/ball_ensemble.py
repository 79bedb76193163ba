"""Ball-action ensemble CLI: mean-blend saved raw predictions, then
postprocess them again (port of the JAX package's
``scripts/ball_action/ensemble.py``).

    python -m ball_action_spotting_torch.cli.ball_ensemble \\
        --experiments EXP1,EXP2 [--folds 0,3] [--challenge]

CV mode blends the experiments fold by fold into
``data/ball_action/predictions/EXP1,EXP2/cv/fold_K``; challenge mode blends
every fold's model of every experiment into
``data/ball_action/predictions/EXP1,EXP2/challenge/ensemble``. Each game
gets its blended npz and spotting JSON there, as the JAX CLI writes them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ball_action_spotting_torch.core.postprocess import raw_predictions_to_actions
from ball_action_spotting_torch.core.spotting import (
    blend_raw_predictions,
    load_raw_predictions,
    save_raw_predictions,
    write_game_spotting_results,
)
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.domains.base import Domain


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiments", required=True, type=str,
                        help="comma-separated experiment names")
    parser.add_argument("--challenge", action="store_true")
    parser.add_argument("--folds", default="all", type=str)
    return parser.parse_args(argv)


def blend_and_write(npz_paths, game: str, out_dir: Path, domain: Domain) -> None:
    """Blend the ``{half}_raw_predictions.npz`` files of one game half by
    half, save the blends and write the game's spotting JSON."""
    by_half: dict[int, list] = {}
    for path in npz_paths:
        half = int(Path(path).name.split("_")[0])
        by_half.setdefault(half, []).append(load_raw_predictions(path))
    half2class_actions = {}
    for half, items in sorted(by_half.items()):
        frame_indexes, blended = blend_raw_predictions(items)
        save_raw_predictions(out_dir / game / f"{half}_raw_predictions.npz",
                             frame_indexes, blended)
        half2class_actions[half] = raw_predictions_to_actions(frame_indexes, blended, domain)
    write_game_spotting_results(half2class_actions, game, out_dir, domain)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    domain = ball.DOMAIN
    experiments = args.experiments.split(",")
    pred_root = domain.predictions_dir
    ens_name = ",".join(experiments)

    if args.challenge:
        out_dir = pred_root / ens_name / "challenge" / "ensemble"
        for game in ball.challenge_games:
            paths = [pred_root / exp / "challenge" / f"fold_{fold}" / game
                     / f"{half}_raw_predictions.npz"
                     for exp in experiments for fold in ball.folds for half in domain.halves]
            blend_and_write([p for p in paths if p.exists()], game, out_dir, domain)
        return
    folds = ball.folds if args.folds == "all" else [int(f) for f in args.folds.split(",")]
    for fold in folds:
        out_dir = pred_root / ens_name / "cv" / f"fold_{fold}"
        for game in ball.fold2games[fold]:
            paths = [pred_root / exp / "cv" / f"fold_{fold}" / game
                     / f"{half}_raw_predictions.npz"
                     for exp in experiments for half in domain.halves]
            blend_and_write([p for p in paths if p.exists()], game, out_dir, domain)


if __name__ == "__main__":
    main()
