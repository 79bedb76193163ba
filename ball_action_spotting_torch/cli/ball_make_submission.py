"""Ball-action challenge submission CLI: zip the challenge ensemble's
spotting JSONs (port of the JAX package's
``scripts/ball_action/make_submission.py``).

    python -m ball_action_spotting_torch.cli.ball_make_submission \\
        --experiments EXP1,EXP2 [--prediction ensemble] [--out PATH]

Packages ``data/ball_action/predictions/EXP1,EXP2/challenge/ensemble`` after
checking that every challenge game is there.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.eval.submission import make_submission_zip


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiments", required=True, type=str,
                        help="comma-joined experiment names, exactly as passed to the "
                             "ensemble CLI (the ensemble directory is named after them)")
    parser.add_argument("--prediction", default="ensemble", type=str,
                        help="subdirectory under challenge/ to package (default: ensemble)")
    parser.add_argument("--out", default=None, type=Path,
                        help="archive path (default: in the prediction dir)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    prediction_dir = (ball.DOMAIN.predictions_dir / args.experiments / "challenge"
                      / args.prediction)
    out = make_submission_zip(prediction_dir, games=ball.challenge_games, out_path=args.out)
    print(f"Submission archive: {out} ({len(ball.challenge_games)} games)")


if __name__ == "__main__":
    main()
