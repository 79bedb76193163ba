"""The port's trainer, checkpoints and configs against the JAX package on
the CPU (tiny arch at 64×96, ``tests/test_train_engine.py``'s config):
``fit`` counts its steps and writes logs and checkpoints; the JAX package
reads a port-written ``.ckpt`` and its model's outputs from it equal the
port's, whose predictor reads the same file; a run interrupted after one
epoch and resumed ends with the weights of an uninterrupted run; each port
config equals the JAX config of the same name.

Tolerance: outputs from the same checkpoint max|Δ| ≤ 1e-4·max|ref| (float32,
as ``test_torch_models.py``); resumed weights must be bitwise equal."""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.domains import ball as jax_ball
from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.train.checkpoint import (
    get_best_checkpoint_path as jax_best_checkpoint,
)
from ball_action_spotting_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from ball_action_spotting_tpu.utils.experiments import (
    load_experiment_config as jax_load_config,
)
from ball_action_spotting_torch import paths
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.core.sampling import ball_sampling_weights
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data import (
    ClipLoader,
    TrainClipDataset,
    ValClipDataset,
    make_synthetic_video_data,
)
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.models.pretrained import PretrainedWeightsError
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor
from ball_action_spotting_torch.train.__main__ import parse_arguments
from ball_action_spotting_torch.train.checkpoint import (
    CheckpointManager,
    get_best_checkpoint_path,
    transfer_weights,
)
from ball_action_spotting_torch.train.engine import RESUME_FILE, Trainer
from ball_action_spotting_torch.utils.experiments import load_experiment_config
from tests.test_torch_models import register_port_tiny_arch
from tests.test_train_engine import CLASSES, tiny_config

register_port_tiny_arch()
ROOT = Path(__file__).resolve().parents[1]
AUG = AugmentConfig(warp_precision="highest")


def loaders():
    videos = make_synthetic_video_data(num_videos=2, num_frames=300, classes=CLASSES)
    weights = [ball_sampling_weights(v, 5, 0.5, 5) for v in videos]
    gen, tproc = StackIndexesGenerator(6, 2), MaxWindowTargetsProcessor(6)
    train_ds = TrainClipDataset(videos, CLASSES, gen, tproc, image_size=(96, 64), epoch_size=16,
                                videos_sampling_weights=weights, base_seed=3)
    val_ds = ValClipDataset(videos, CLASSES, gen, tproc, image_size=(96, 64))
    return (ClipLoader(train_ds, 8, num_workers=2, ordered=True),
            ClipLoader(val_ds, 8, num_workers=2, ordered=True))


def trainer(save_dir, config=None):
    return Trainer(config or tiny_config(), CLASSES, save_dir, augment=AUG,
                   compute_dtype=torch.float32, device="cpu", seed=1)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("fit")
    tr = trainer(save_dir)
    best = tr.fit(*loaders())
    return tr, best, save_dir


def test_fit_runs_counts_steps_and_checkpoints(fitted):
    tr, best, save_dir = fitted
    assert tr.state.step == 6  # 3 epochs × 2 steps
    assert np.isfinite(best["train_loss"]) and "val_average_precision" in best
    assert (save_dir / "log.txt").exists()
    assert "val_average_precision" in (save_dir / "log.csv").read_text()
    assert not (save_dir / RESUME_FILE).exists()  # dropped once the run completed
    assert len(list(save_dir.glob("*.ckpt"))) == 1  # max_saves=1
    ema = dict(tr.state.ema.named_parameters())
    raw = dict(tr.state.model.named_parameters())
    assert not torch.allclose(ema["classifier.bias"], raw["classifier.bias"])


def test_jax_reads_port_checkpoint_and_outputs_match(fitted):
    _, _, save_dir = fitted
    ckpt = get_best_checkpoint_path(save_dir)
    assert ckpt is not None and jax_best_checkpoint(save_dir) == ckpt
    variables, params = jax_load_checkpoint(ckpt)
    raw_variables, _ = jax_load_checkpoint(ckpt, use_ema=False)
    assert "batch_stats" in variables and "batch_stats" in raw_variables
    assert params["nn_module"][0] == "multidim_stacker"
    assert params["frames_processor"][1]["size"] == [96, 64]

    x = np.random.default_rng(0).random((2, 6, 64, 96)).astype(np.float32)
    jax_model = jax_build_model(params["nn_module"][0], **params["nn_module"][1])
    expected = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    predictor = ChunkedVideoPredictor(ckpt, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        out = predictor.model(torch.from_numpy(x)).numpy()
    assert np.abs(out - expected).max() <= 1e-4 * np.abs(expected).max()


class Interrupted(Exception):
    pass


class StopAtEpoch:
    """A loader that fails when the given epoch starts."""

    def __init__(self, loader, epoch):
        self.loader, self.stop = loader, epoch

    def epoch(self, epoch):
        if epoch == self.stop:
            raise Interrupted
        return self.loader.epoch(epoch)


def test_resumed_run_ends_with_the_uninterrupted_weights(fitted, tmp_path):
    tr_full, _, _ = fitted
    train_loader, val_loader = loaders()
    with pytest.raises(Interrupted):
        trainer(tmp_path).fit(StopAtEpoch(train_loader, 1), val_loader)
    assert (tmp_path / RESUME_FILE).exists()
    resumed = trainer(tmp_path)
    resumed.fit(train_loader, val_loader)
    assert resumed.state.step == tr_full.state.step
    for which in ("model", "ema"):
        full = getattr(tr_full.state, which).state_dict()
        for name, value in getattr(resumed.state, which).state_dict().items():
            assert torch.equal(value, full[name]), (which, name)


def test_frozen_encoder_and_stage_pretrain(fitted, tmp_path):
    tr_full, _, _ = fitted
    config = tiny_config(num_epochs=[1], stages=["train"])
    config["argus_params"]["freeze_conv2d_encoder"] = True
    tr = trainer(tmp_path, config)
    state = tr.init_state(pretrain_variables=tr_full.variables(ema=True))
    before = copy.deepcopy(state.model.state_dict())
    assert torch.equal(before["conv2d_encoder.conv_stem.weight"],
                       tr_full.state.ema.state_dict()["conv2d_encoder.conv_stem.weight"])
    tr.train_epoch(loaders()[0], 0)
    after = state.model.state_dict()
    assert torch.equal(before["conv2d_encoder.conv_stem.weight"],
                       after["conv2d_encoder.conv_stem.weight"])
    assert not torch.equal(before["classifier.weight"], after["classifier.weight"])
    assert not torch.equal(before["conv2d_encoder.bn1.running_mean"],
                           after["conv2d_encoder.bn1.running_mean"])


def test_checkpoint_manager_and_transfer(tmp_path):
    manager = CheckpointManager(tmp_path, max_saves=2, tie_keep="last")
    tree = {"params": {"p": np.ones(1, np.float32)}}
    for epoch, score in enumerate((0.5, 0.7, 0.7, 0.6)):
        manager.save(epoch, score, {"nn_module": ["x", {}]}, tree)
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == [
        "model-001-0.700000.ckpt", "model-002-0.700000.ckpt"]
    assert get_best_checkpoint_path(tmp_path).name == "model-002-0.700000.ckpt"
    state = {"a": torch.zeros(2, 3), "b": torch.zeros(4)}
    out = transfer_weights(state, {"a": torch.ones(2, 3), "b": torch.ones(5)}, verbose=False)
    assert torch.equal(out["a"], torch.ones(2, 3)) and torch.equal(out["b"], torch.zeros(4))


@pytest.mark.parametrize("name", ["sampling_weights_001", "ball_tuning_001",
                                  "ball_finetune_long_004"])
def test_port_configs_equal_the_jax_configs(name):
    port = load_experiment_config(name, ball.DOMAIN)
    ref = jax_load_config(name, jax_ball.DOMAIN, configs_dir=ROOT / "configs" / "ball_action")
    assert port == ref
    assert paths.configs_dir() == ROOT / "ball_action_spotting_torch" / "configs"


def test_trainer_and_cli_need_cuda_or_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_config(), CLASSES, tmp_path)
    args = parse_arguments(["--experiment", "sampling_weights_001", "--folds", "0,3"])
    assert (args.device, args.folds, args.seed) == ("cuda", "0,3", 0)
    # the shipped stage-1 config needs its ImageNet file and never trains
    # from a random init without it
    monkeypatch.setenv("BAS_TPU_PRETRAINED_DIR", str(tmp_path / "empty"))
    config = load_experiment_config("sampling_weights_001", ball.DOMAIN)
    with pytest.raises(PretrainedWeightsError, match="pretrained=True"):
        Trainer(config, CLASSES, tmp_path, device="cpu").init_state()
