"""The port's rehearsal CLI (``cli/rehearsal.py``) on the CPU in one process
(``--in_process --device cpu``), after ``tests/test_rehearsal.py``: the
port's configs cut by ``tests/test_torch_chain.py::shrink`` (tiny arch,
64×96), gray stores from the port's writer. It checks the artifacts the
JAX rehearsal test checks (every stage's checkpoints, the out-of-fold npz
of every game, the ensemble's JSONs and evaluation, the challenge
predictions and ensemble) and the challenge zip made from them, and that
the default mode runs each step as ``python -m <CLI>``."""

import json

import numpy as np
import pytest
import torch

from ball_action_spotting_torch.cli import ball_make_submission, rehearsal
from ball_action_spotting_torch.domains import action, ball
from ball_action_spotting_torch.eval.soccernet_map import evaluate_games
from ball_action_spotting_torch.train.checkpoint import get_best_checkpoint_path, load_checkpoint
from ball_action_spotting_torch.utils.experiments import load_experiment_config
from tests.test_torch_chain import (
    ACTION_EVENTS,
    ACTION_GAMES,
    BALL_EVENTS,
    ROOT,
    STAGES,
    shrink,
    write_game,
)

S1, S2, S3, S4 = "sampling_weights_001", "action_sampling_weights_002", "ball_tuning_001", \
    "ball_finetune_long_004"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("rehearsal_wd")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny arch gains nothing from intra-op threads
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("BAS_TPU_WORKDIR", str(wd))
            mp.setenv("BAS_TPU_CONFIGS_DIR", str(wd / "configs"))
            mp.setenv("BAS_TPU_ACTION_SPLITS", str(wd / "splits"))
            for domain_name, names in STAGES.items():
                domain = action.DOMAIN if domain_name == "action" else ball.DOMAIN
                (wd / "configs" / domain_name).mkdir(parents=True)
                for name in names:
                    config = load_experiment_config(
                        name, domain,
                        configs_dir=ROOT / "ball_action_spotting_torch" / "configs" / domain_name)
                    (wd / "configs" / domain_name / f"{name}.py").write_text(
                        f"config = {shrink(config)!r}\n")
            (wd / "splits").mkdir()
            (wd / "splits" / "train.json").write_text(json.dumps(ACTION_GAMES[:1]))
            (wd / "splits" / "val.json").write_text(json.dumps(ACTION_GAMES[1:]))
            for i, game in enumerate(ball.fold_games + ball.challenge_games):
                write_game(ball.DOMAIN.soccernet_dir / game, "Labels-ball.json", BALL_EVENTS,
                           False, 10 * i)
            for i, game in enumerate(ACTION_GAMES):
                write_game(action.DOMAIN.soccernet_dir / game, "Labels-v2.json", ACTION_EVENTS,
                           True, 100 + 10 * i)
            rehearsal.main(["--stage_folds", "0", "--in_process", "--device", "cpu"])
            ball_make_submission.main(["--experiments", S4])
            yield wd
    finally:
        torch.set_num_threads(threads)


def test_stage1_checkpoints_and_oof_predictions_of_every_fold(workdir):
    preds = ball.DOMAIN.predictions_dir / S1 / "cv"
    for fold in ball.folds:
        assert get_best_checkpoint_path(ball.DOMAIN.experiments_dir / S1 / f"fold_{fold}")
        for game in ball.fold2games[fold]:
            for half in (1, 2):
                assert (preds / f"fold_{fold}" / game / f"{half}_raw_predictions.npz").exists()
        results = json.loads((preds / f"fold_{fold}" / "evaluate_results.json").read_text())
        assert 0.0 <= results["a_mAP"] <= 1.0


def test_stages_2_to_4_trained_from_their_pretrains(workdir):
    assert get_best_checkpoint_path(action.DOMAIN.experiments_dir / S2)
    assert get_best_checkpoint_path(ball.DOMAIN.experiments_dir / S3 / "fold_0")
    s4 = get_best_checkpoint_path(ball.DOMAIN.experiments_dir / S4 / "fold_0")
    _, params = load_checkpoint(s4)
    assert params["frame_stack_size"] == 33 and params["freeze_conv2d_encoder"]
    assert not (ball.DOMAIN.experiments_dir / S3 / "fold_1").exists()  # --stage_folds 0


def test_cv_ensemble_and_its_evaluation(workdir):
    ens = ball.DOMAIN.predictions_dir / f"{S3},{S4}" / "cv" / "fold_0"
    game = ball.fold2games[0][0]
    for half in (1, 2):
        with np.load(ens / game / f"{half}_raw_predictions.npz") as z:
            assert np.isfinite(z["raw_predictions"]).all()
    assert json.loads((ens / game / "results_spotting.json").read_text())["UrlLocal"] == game
    results = json.loads((ens / "evaluate_results.json").read_text())
    assert 0.0 <= results["a_mAP"] <= 1.0


def test_challenge_predictions_ensemble_and_zip(workdir):
    preds = ball.DOMAIN.predictions_dir / S4 / "challenge"
    for game in ball.challenge_games:
        assert (preds / "fold_0" / game / "1_raw_predictions.npz").exists()
        assert (preds / "ensemble" / game / "results_spotting.json").exists()
    archive = preds / "ensemble" / "results_spotting.zip"
    from_dir = evaluate_games(ball.DOMAIN.soccernet_dir, preds / "ensemble", ball.challenge_games,
                              ball.DOMAIN)
    assert evaluate_games(ball.DOMAIN.soccernet_dir, archive, ball.challenge_games,
                          ball.DOMAIN) == from_dir


def test_default_mode_runs_each_step_as_a_module(monkeypatch):
    calls = []
    monkeypatch.setattr(rehearsal.subprocess, "run",
                        lambda cmd, check, env: calls.append((cmd, env["PYTHONPATH"])))
    rehearsal.main(["--stage_folds", "0", "--fused_challenge", "--skip_challenge"])
    modules = [cmd[2] for cmd, _ in calls]
    assert modules == [rehearsal.TRAIN, rehearsal.PREDICT, rehearsal.EVALUATE,
                       rehearsal.ACTION_TRAIN, rehearsal.TRAIN, rehearsal.TRAIN,
                       rehearsal.PREDICT, rehearsal.PREDICT, rehearsal.ENSEMBLE,
                       rehearsal.EVALUATE]
    assert all(cmd[1] == "-m" and path.split(":")[0] == str(ROOT) for cmd, path in calls)
    devices = [cmd[cmd.index("--device") + 1] for cmd, _ in calls if "--device" in cmd]
    assert devices == ["cuda"] * 7  # the CLIs that take one: train, predict, action train
    calls.clear()
    rehearsal.main(["--stage2", "", "--fused_challenge", "--device", "cpu"])
    assert [cmd[2] for cmd, _ in calls][-2:] == [rehearsal.PREDICT, rehearsal.ENSEMBLE]
    assert "--fused" in calls[-2][0] and rehearsal.ACTION_TRAIN not in [c[2] for c, _ in calls]
