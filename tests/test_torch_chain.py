"""The four-stage recipe through the port's CLIs on the CPU, in one process
(``main(argv)`` calls with ``--device cpu``), after
``tests/test_rehearsal.py::test_four_stage_rehearsal_fast`` and
``tests/test_cli_action_workflow.py``:

1. stage 1, ``sampling_weights_001``: train all 7 folds, predict every
   fold's game (the out-of-fold npz stage 3 samples hard negatives from),
   evaluate at "at1";
2. stage 2, ``action_sampling_weights_002``: action train → predict → evaluate
   at "tight", on split lists from ``BAS_TPU_ACTION_SPLITS``;
3. stage 3, ``ball_tuning_001`` on fold 0, from the action checkpoint: every
   tensor but the 15-class classifier is loaded;
4. stage 4, ``ball_finetune_long_004`` on fold 0: 33 frames, the 2D encoder
   frozen, so its parameters stay bit for bit;
5. stages 3 and 4 predicted, ensembled, evaluated; stage 4's challenge
   predictions ensembled and zipped, and the zip scored by ``evaluate_games``.

The configs are the port's own, cut to the tiny arch at 64×96, batch 4, one
warmup and one train epoch of 8 samples each."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ball_action_spotting_torch.cli import (
    action_evaluate,
    action_predict,
    action_train,
    ball_ensemble,
    ball_evaluate,
    ball_make_submission,
)
from ball_action_spotting_torch.convert import flax_tree_to_state_dict
from ball_action_spotting_torch.data.gray_store import write_gray_store
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import action, ball
from ball_action_spotting_torch.eval.soccernet_map import evaluate_games
from ball_action_spotting_torch.predict.__main__ import main as ball_predict
from ball_action_spotting_torch.train.__main__ import main as ball_train
from ball_action_spotting_torch.train.checkpoint import get_best_checkpoint_path, load_checkpoint
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.utils.experiments import load_experiment_config

ROOT = Path(__file__).resolve().parents[1]
H, W, FRAMES = 64, 96, 100
ACTION_GAMES = ["league/a1", "league/a2"]
# frame → label of every half: ball events at 1, 2 and 3 s; action events
# with two card classes and one annotation the visibility filter drops
BALL_EVENTS = {25: "PASS", 50: "DRIVE", 75: "PASS"}
ACTION_EVENTS = {25: ("Goal", "visible"), 50: ("Yellow card", "visible"),
                 75: ("Red card", "visible"), 88: ("Corner", "not shown")}
STAGES = {"ball_action": ["sampling_weights_001", "ball_tuning_001", "ball_finetune_long_004"],
          "action": ["action_sampling_weights_002"]}


def shrink(config: dict) -> dict:
    """A port config at the tiny arch, 64×96, batch 4, 2 + 2 steps; its
    recipe deltas (stack size, losses, optimizer, freezing, sampling
    weights, pretrain experiments) stay."""
    config = copy.deepcopy(config)
    ap = config["argus_params"]
    name, kwargs = ap["nn_module"]
    kwargs.update(model_name="efficientnetv2_tiny", pretrained=False, num_3d_blocks=1,
                  num_3d_features=16, expansion_3d_ratio=2, se_reduce_3d_ratio=4,
                  num_3d_stack_proj=16, drop_rate=0.0, drop_path_rate=0.0)
    ap["image_size"] = (W, H)
    ap["frames_processor"] = ("pad_normalize", {"size": (W, H)})
    config.update(image_size=(W, H), batch_size=4, train_epoch_size=8, num_epochs=[1, 1],
                  num_decode_workers=2)
    return config


def write_game(game_dir, label_file, events, with_visibility, seed):
    annotations = []
    for half in (1, 2):
        labels = [e[0] if with_visibility else e for e in events.values()]
        classes = sorted(set(labels))
        src = SyntheticSource(num_frames=FRAMES, height=H, width=W, seed=seed + half,
                              events={f: classes.index(lab) for f, lab in zip(events, labels)})
        video = game_dir / f"{half}_720p.mkv"
        write_gray_store(str(video) + ".gray", (src.fetch_frame(i) for i in range(FRAMES)),
                         H, W, FRAMES)
        (game_dir / f"{half}_720p.mkv.info.json").write_text(json.dumps(
            dict(frame_count=FRAMES, fps=25.0, width=W, height=H)))
        for frame, event in events.items():
            ann = {"gameTime": f"{half} - 00:{frame // 25:02d}", "position": str(frame * 40)}
            if with_visibility:
                ann.update(label=event[0], visibility=event[1])
            else:
                ann["label"] = event
            annotations.append(ann)
    (game_dir / label_file).write_text(json.dumps({"annotations": annotations}))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    wd = tmp_path_factory.mktemp("chain_wd")
    # the tiny arch gains nothing from intra-op threads, and beside the
    # suite's other workers they oversubscribe the cores (~1.5x slower)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("BAS_TPU_WORKDIR", str(wd))
            mp.setenv("BAS_TPU_CONFIGS_DIR", str(wd / "configs"))
            mp.setenv("BAS_TPU_ACTION_SPLITS", str(wd / "splits"))
            for domain_name, names in STAGES.items():
                (wd / "configs" / domain_name).mkdir(parents=True)
                for name in names:
                    config = load_experiment_config(
                        name, action.DOMAIN if domain_name == "action" else ball.DOMAIN,
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

            # the state every Trainer starts its first step from, by save dir
            initial = {}
            init_state = Trainer.init_state

            def recording_init_state(self, pretrain_variables=None):
                state = init_state(self, pretrain_variables)
                initial[self.save_dir.relative_to(wd).as_posix()] = {
                    k: v.detach().clone() for k, v in state.model.state_dict().items()}
                return state

            mp.setattr(Trainer, "init_state", recording_init_state)
            cpu = ["--device", "cpu"]
            ball_train(["--experiment", "sampling_weights_001", *cpu])
            ball_predict(["--experiment", "sampling_weights_001", *cpu])
            ball_evaluate.main(["--experiment", "sampling_weights_001"])

            action_train.main(["--experiment", "action_sampling_weights_002", *cpu])
            action_predict.main(["--experiment", "action_sampling_weights_002", *cpu])
            action_evaluate.main(["--experiment", "action_sampling_weights_002",
                                  "--algorithm", "matcher"])
            action_evaluate.main(["--experiment", "action_sampling_weights_002"])

            ball_train(["--experiment", "ball_tuning_001", "--folds", "0", *cpu])
            ball_train(["--experiment", "ball_finetune_long_004", "--folds", "0", *cpu])
            for exp in ("ball_tuning_001", "ball_finetune_long_004"):
                ball_predict(["--experiment", exp, "--folds", "0", *cpu])
            ens = "ball_tuning_001,ball_finetune_long_004"
            ball_ensemble.main(["--experiments", ens, "--folds", "0"])
            ball_evaluate.main(["--experiment", ens, "--folds", "0", "--algorithm", "matcher"])
            ball_predict(["--experiment", "ball_finetune_long_004", "--folds", "0", "--challenge",
                          *cpu])
            ball_ensemble.main(["--experiments", "ball_finetune_long_004", "--challenge"])
            ball_make_submission.main(["--experiments", "ball_finetune_long_004"])
            yield initial
    finally:
        torch.set_num_threads(threads)


def test_stage1_writes_every_fold_and_its_oof_predictions(chain):
    for fold in ball.folds:
        assert get_best_checkpoint_path(
            ball.DOMAIN.experiments_dir / "sampling_weights_001" / f"fold_{fold}")
        fold_dir = ball.DOMAIN.predictions_dir / "sampling_weights_001/cv" / f"fold_{fold}"
        for half in (1, 2):
            with np.load(fold_dir / ball.fold2games[fold][0] / f"{half}_raw_predictions.npz") as z:
                raw = z["raw_predictions"]
                assert raw.shape == (len(z["frame_indexes"]), 2) and len(raw) > 0
                assert np.isfinite(raw).all()
        results = json.loads((fold_dir / "evaluate_results.json").read_text())
        assert 0.0 <= results["a_mAP"] <= 1.0 and results["metric"] == "at1"


def test_stage2_action_train_predict_evaluate(chain):
    exp_dir = action.DOMAIN.experiments_dir / "action_sampling_weights_002"
    _, params = load_checkpoint(get_best_checkpoint_path(exp_dir))
    assert params["nn_module"][1]["num_classes"] == 15
    pred_dir = action.DOMAIN.predictions_dir / "action_sampling_weights_002/val"
    spotting = json.loads((pred_dir / ACTION_GAMES[1] / "results_spotting.json").read_text())
    labels = {p["label"] for p in spotting["predictions"]}
    assert "Card" not in labels and labels <= set(action.classes) | {"Yellow card"}
    results = json.loads((pred_dir / "evaluate_results.json").read_text())
    assert results["metric"] == "tight" and 0.0 <= results["a_mAP"] <= 1.0
    assert results["a_mAP_visible"] is not None and len(results["a_mAP_per_class"]) == 15


def test_stage3_loads_every_action_tensor_but_the_classifier(chain):
    initial = chain
    action_ckpt = get_best_checkpoint_path(
        action.DOMAIN.experiments_dir / "action_sampling_weights_002")
    pretrain = flax_tree_to_state_dict(load_checkpoint(action_ckpt)[0])
    start = initial["data/ball_action/experiments/ball_tuning_001/fold_0"]
    assert set(start) == set(pretrain)
    skipped = sorted(k for k in start if start[k].shape != pretrain[k].shape)
    assert skipped == ["classifier.bias", "classifier.weight"]
    for name, value in start.items():
        if name not in skipped:
            assert torch.equal(value, pretrain[name].to(value.dtype)), name


def test_stage4_runs_33_frames_with_the_encoder_unchanged(chain):
    initial = chain
    exp_dir = ball.DOMAIN.experiments_dir / "ball_finetune_long_004/fold_0"
    variables, params = load_checkpoint(get_best_checkpoint_path(exp_dir), use_ema=False)
    assert params["frame_stack_size"] == 33 and params["freeze_conv2d_encoder"]
    after = flax_tree_to_state_dict(variables)
    start = initial["data/ball_action/experiments/ball_finetune_long_004/fold_0"]
    encoder = [k for k in start if k.startswith("conv2d_encoder.")
               and "running_" not in k and "num_batches" not in k]
    assert encoder
    for name in encoder:
        assert torch.equal(after[name].to(start[name].dtype), start[name]), name
    assert not torch.equal(after["classifier.weight"].to(torch.float32),
                           start["classifier.weight"].to(torch.float32))


def test_ensemble_and_submission_zip_score_like_the_directory(chain):
    preds = ball.DOMAIN.predictions_dir
    ens = preds / "ball_tuning_001,ball_finetune_long_004/cv/fold_0"
    results = json.loads((ens / "evaluate_results.json").read_text())
    assert 0.0 <= results["a_mAP"] <= 1.0
    challenge = preds / "ball_finetune_long_004/challenge/ensemble"
    labels = ball.DOMAIN.soccernet_dir
    for algorithm in ("official", "matcher"):
        from_dir = evaluate_games(labels, challenge, ball.challenge_games, ball.DOMAIN,
                                  algorithm=algorithm)
        from_zip = evaluate_games(labels, challenge / "results_spotting.zip",
                                  ball.challenge_games, ball.DOMAIN, algorithm=algorithm)
        assert from_zip == from_dir and 0.0 <= from_zip["a_mAP"] <= 1.0


def test_model_clis_need_cuda_or_cpu(chain):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        action_predict.main(["--experiment", "action_sampling_weights_002"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ball_predict(["--experiment", "ball_tuning_001", "--folds", "0"])
