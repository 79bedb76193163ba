"""The four-stage recipe end to end through the port's CLIs (port of the JAX
package's ``scripts/rehearsal.py``, with the same flags and the same order
of steps, plus ``--device``):

  1. stage-1 train over the CV folds
  2. CV predict of the same folds  -> the out-of-fold raw-prediction npz
                                      that stage 3 samples hard negatives from
  3. stage-1 evaluate              -> mAP@1 per fold
  4. stage-2 action train          -> the cross-domain pretrain stage 3
                                      starts from
  5. stage-3 train                 -> OOF hard negatives + the stage pretrain
  6. stage-4 train                 -> long-window frozen-encoder fine-tune
                                      from stage 3, same fold
  7. stage-3 and stage-4 CV predict
  8. ensemble of stages 3 and 4 (cv) -> blended spotting JSONs
  9. evaluate the cv ensemble
 10. stage-4 challenge predict and challenge ensemble

    python -m ball_action_spotting_torch.cli.rehearsal [--device cuda]
    python -m ball_action_spotting_torch.cli.rehearsal --stage_folds 0 \\
        --in_process --device cpu

Stage 3 reads the stage-1 predictions of every game it trains on, so
``--folds`` (stage 1's) must cover every fold but those of
``--stage_folds``. By default each step runs as its own process
(``python -m ...``), which proves each CLI as an entry point;
``--in_process`` calls each CLI's ``main(argv)`` in this process.
``--device`` goes to every CLI that takes one (train, predict, action
train); the evaluate and ensemble CLIs are numpy only.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
from pathlib import Path

TRAIN = "ball_action_spotting_torch.train"
PREDICT = "ball_action_spotting_torch.predict"
EVALUATE = "ball_action_spotting_torch.cli.ball_evaluate"
ENSEMBLE = "ball_action_spotting_torch.cli.ball_ensemble"
ACTION_TRAIN = "ball_action_spotting_torch.cli.action_train"
REPO = Path(__file__).resolve().parents[2]


def run_subprocess(module: str, argv: list[str]) -> None:
    cmd = [sys.executable, "-m", module, *argv]
    print("+", " ".join(cmd), flush=True)
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    subprocess.run(cmd, check=True, env=dict(os.environ, PYTHONPATH=path))


def run_in_process(module: str, argv: list[str]) -> None:
    """Import the CLI's module (a package's ``__main__``) and call its
    ``main(argv)``."""
    print("+ [in-process]", module, " ".join(argv), flush=True)
    mod = importlib.import_module(module)
    if hasattr(mod, "__path__"):  # a package run with -m: its __main__
        mod = importlib.import_module(f"{module}.__main__")
    mod.main(argv)


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stage1", default="sampling_weights_001")
    parser.add_argument("--stage2", default="action_sampling_weights_002",
                        help="action-domain pretrain experiment trained before stage 3 (the "
                             "recipe's stage 2); empty string skips it (the stage-3 config "
                             "must then name a ball pretrain instead)")
    parser.add_argument("--stage3", default="ball_tuning_001")
    parser.add_argument("--stage4", default="ball_finetune_long_004")
    parser.add_argument("--folds", default="all",
                        help="folds for stage-1 train + OOF predict (stage 3 needs OOF npz "
                             "for every train game, i.e. all)")
    parser.add_argument("--stage_folds", default="all",
                        help="folds to carry through stages 3/4 + ensemble")
    parser.add_argument("--skip_challenge", action="store_true")
    parser.add_argument("--fused_challenge", action="store_true",
                        help="run the challenge predict through the fused multi-fold engine "
                             "(predict --fused: one decode and upload per video for ALL folds)")
    parser.add_argument("--in_process", action="store_true",
                        help="call each CLI's main(argv) in THIS process instead of a "
                             "subprocess")
    parser.add_argument("--device", default="cuda", type=str)
    return parser.parse_args(argv)


def steps(a) -> list[tuple[str, list[str]]]:
    """The chain's (CLI module, argv) steps, in order."""
    dev = ["--device", a.device]
    out = [
        # stage 1: train the folds, then out-of-fold predictions of their games
        (TRAIN, ["--experiment", a.stage1, "--folds", a.folds, *dev]),
        (PREDICT, ["--experiment", a.stage1, "--folds", a.folds, *dev]),
        (EVALUATE, ["--experiment", a.stage1, "--folds", a.folds]),
    ]
    if a.stage2:  # stage 2: the action-domain pretrain stage 3 starts from
        out.append((ACTION_TRAIN, ["--experiment", a.stage2, *dev]))
    ens = f"{a.stage3},{a.stage4}"
    out += [
        # stage 3: OOF hard negatives from stage 1 + the stage pretrain
        (TRAIN, ["--experiment", a.stage3, "--folds", a.stage_folds, *dev]),
        # stage 4: long-window frozen-encoder fine-tune from stage 3, same fold
        (TRAIN, ["--experiment", a.stage4, "--folds", a.stage_folds, *dev]),
        # CV predictions for both tuned stages, then the fold ensemble
        (PREDICT, ["--experiment", a.stage3, "--folds", a.stage_folds, *dev]),
        (PREDICT, ["--experiment", a.stage4, "--folds", a.stage_folds, *dev]),
        (ENSEMBLE, ["--experiments", ens, "--folds", a.stage_folds]),
        (EVALUATE, ["--experiment", ens, "--folds", a.stage_folds]),
    ]
    if not a.skip_challenge:
        fused = ["--fused"] if a.fused_challenge else []
        out += [
            (PREDICT, ["--experiment", a.stage4, "--challenge", "--folds", a.stage_folds,
                       *fused, *dev]),
            (ENSEMBLE, ["--experiments", a.stage4, "--challenge"]),
        ]
    return out


def main(argv=None) -> None:
    a = parse_arguments(argv)
    run = run_in_process if a.in_process else run_subprocess
    for module, args in steps(a):
        run(module, args)
    print("rehearsal complete", flush=True)


if __name__ == "__main__":
    main()
