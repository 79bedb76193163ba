"""The port's fused multi-fold engine (``predict/fused.py``) and its
parallel modes on the CPU, against the port's single-fold engine and the
JAX package's ``FusedFoldsPredictor`` on the same JAX-written checkpoints
(mirrors ``tests/test_fused_ensemble.py``).

Tolerances: float32 on both sides. Fused against the port's single-fold
engine, and every grid against one device: atol 1e-6 (the same ops on the
same rows). Against JAX: atol 1e-5, as ``tests/test_torch_predict.py``.
Pipeline files against the per-fold loop: atol 1e-6, labels and positions
identical."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.domains import ball as jax_ball
from ball_action_spotting_tpu.predict import pipeline as jax_pipeline
from ball_action_spotting_tpu.predict.fused import FusedFoldsPredictor as JaxFusedFoldsPredictor
from ball_action_spotting_tpu.predict.streaming import (
    iter_source_frames as jax_iter_source_frames,
)
from ball_action_spotting_torch.data.gray_store import write_gray_store
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.__main__ import main as predict_cli
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.pipeline import predict_games, predict_games_fused
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    iter_source_frames,
)
from ball_action_spotting_torch.convert import state_dict_to_flax_tree
from ball_action_spotting_torch.models import build_model, init_train_weights
from ball_action_spotting_torch.models.effnetv2 import BatchNormAct
from ball_action_spotting_torch.train.checkpoint import save_checkpoint
from tests.test_predictor import NN_KWARGS, PARAMS
from tests.test_torch_models import register_port_tiny_arch

register_port_tiny_arch()

FRAME_COUNT = 40
SRC_KWARGS = dict(num_frames=FRAME_COUNT, height=64, width=96, seed=1, events={20: 0, 30: 1})
F32 = dict(dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny arch gains nothing from intra-op threads, and beside the
    suite's other workers they oversubscribe the cores (as
    ``tests/test_torch_chain.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_ckpt(path, seed: int = 3, nn_kwargs=NN_KWARGS, params=PARAMS):
    """A ``.ckpt`` of the tiny arch written by the port, which both
    packages read (no JAX model init to compile): weights from ``seed``
    with every BN's scale, bias and statistics randomized (an identity BN
    would hide a wrong eps or fold), the raw tree from ``seed + 100``."""
    def tree(s):
        model = build_model("multidim_stacker", **nn_kwargs)
        init_train_weights(model, torch.Generator().manual_seed(s))
        rng = np.random.default_rng(s)
        with torch.no_grad():
            for bn in (m for m in model.modules() if isinstance(m, BatchNormAct)):
                c = bn.bias.shape[0]
                bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c)))
                bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c)))
                bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        return state_dict_to_flax_tree(model.state_dict(), model)

    save_checkpoint(path, params, tree(seed), tree(seed + 100))
    return path


def frames():
    return iter_source_frames(SyntheticSource(**SRC_KWARGS))


def cpu_grid(n_data, n_model):
    return make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))


@pytest.fixture(scope="module")
def fold_ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("folds")
    return [make_ckpt(d / f"model-00{i}-0.50000{i}.ckpt", seed=10 + i) for i in range(3)]


@pytest.fixture(scope="module")
def single_raws(fold_ckpts):
    """Each fold's single-fold engine: chunk 10 TTA off, chunk 16 TTA on."""
    out = {}
    for tta, chunk in ((False, 10), (True, 16)):
        for i, ckpt in enumerate(fold_ckpts):
            engine = ChunkedVideoPredictor(ckpt, tta=tta, chunk_size=chunk, **F32)
            out[tta, i] = engine.predict_video(frames(), FRAME_COUNT)
    return out


@pytest.mark.parametrize("carry_features", [True, False])
@pytest.mark.parametrize("tta", [False, True])
def test_fused_matches_single_fold(fold_ckpts, single_raws, tta, carry_features):
    chunk = 16 if tta else 10
    fused = FusedFoldsPredictor(fold_ckpts, tta=tta, chunk_size=chunk,
                                carry_features=carry_features, **F32)
    idx, raw = fused.predict_video(frames(), FRAME_COUNT)
    assert raw.shape == (len(idx), 3, 2)
    for i in range(3):
        s_idx, s_raw = single_raws[tta, i]
        assert list(idx) == list(s_idx)
        np.testing.assert_allclose(raw[:, i], s_raw, atol=1e-6)


@pytest.mark.parametrize("tta", [False, True])
def test_fused_matches_jax(fold_ckpts, tta):
    chunk = 16 if tta else 10
    jax_engine = JaxFusedFoldsPredictor(fold_ckpts, tta=tta, dtype=jnp.float32,
                                        chunk_size=chunk)
    j_idx, j_raw = jax_engine.predict_video(
        jax_iter_source_frames(JaxSyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    fused = FusedFoldsPredictor(fold_ckpts, tta=tta, chunk_size=chunk, **F32)
    idx, raw = fused.predict_video(frames(), FRAME_COUNT)
    assert list(idx) == list(j_idx) and raw.shape == j_raw.shape == (28, 3, 2)
    np.testing.assert_allclose(raw, j_raw, atol=1e-5)


def test_single_checkpoint_and_short_video(fold_ckpts):
    fused = FusedFoldsPredictor(fold_ckpts[:1], chunk_size=10, **F32)
    idx, raw = fused.predict_video(frames(), FRAME_COUNT)
    assert raw.shape == (len(idx), 1, 2)
    fused = FusedFoldsPredictor(fold_ckpts, chunk_size=8, **F32)
    src = SyntheticSource(num_frames=8, height=64, width=96, seed=1)
    idx, raw = fused.predict_video(iter_source_frames(src), 8)
    assert idx == [] and raw.shape == (0, 3, 2)


def test_incompatible_and_missing_checkpoints(fold_ckpts, tmp_path):
    bad_kwargs = dict(NN_KWARGS, num_classes=3)
    bad = make_ckpt(tmp_path / "model-001-0.100000.ckpt", seed=7, nn_kwargs=bad_kwargs,
                    params=dict(PARAMS, nn_module=("multidim_stacker", bad_kwargs)))
    with pytest.raises(ValueError, match="identical 'nn_module'"):
        FusedFoldsPredictor([fold_ckpts[0], bad], **F32)
    with pytest.raises(ValueError, match="at least one checkpoint"):
        FusedFoldsPredictor([], **F32)


def test_fold_parallel_guards(fold_ckpts):
    with pytest.raises(ValueError, match="requires mesh"):
        FusedFoldsPredictor(fold_ckpts, fold_parallel=True, **F32)
    with pytest.raises(ValueError, match="data axis"):
        FusedFoldsPredictor(fold_ckpts, mesh=cpu_grid(2, 2), fold_parallel=True, **F32)


@pytest.mark.parametrize("n_model,tta", [(2, False), (4, False), (2, True)])
def test_fold_parallel_matches_the_loop(fold_ckpts, single_raws, n_model, tta):
    """Folds over a 1×2 grid (3 folds padded to 4) and a 1×4 grid (padded to
    4: one device runs only the padding); each fold's slice equals its
    single-fold engine."""
    chunk = 16 if tta else 10
    par = FusedFoldsPredictor(fold_ckpts, tta=tta, chunk_size=chunk,
                              mesh=cpu_grid(1, n_model), fold_parallel=True, **F32)
    assert len(par.fold_shares) == 4 and par.num_folds == 3
    idx, raw = par.predict_video(frames(), FRAME_COUNT)
    assert raw.shape == (len(idx), 3, 2)
    for i in range(3):
        s_idx, s_raw = single_raws[tta, i]
        assert list(idx) == list(s_idx)
        np.testing.assert_allclose(raw[:, i], s_raw, atol=1e-6)


@pytest.mark.parametrize("carry_features", [True, False])
def test_fused_on_a_data_grid_matches_one_device(fold_ckpts, single_raws, carry_features):
    fused = FusedFoldsPredictor(fold_ckpts, chunk_size=10, mesh=cpu_grid(2, 1),
                                carry_features=carry_features, **F32)
    idx, raw = fused.predict_video(frames(), FRAME_COUNT)
    for i in range(3):
        np.testing.assert_allclose(raw[:, i], single_raws[False, i][1], atol=1e-6)


def test_cli_fused_flag_validation():
    cases = [
        (["--experiment", "x", "--fused"], "requires --challenge"),
        (["--experiment", "x", "--fused", "--challenge", "--use_saved_predictions"],
         "use_saved_predictions"),
        (["--experiment", "x", "--fused", "--challenge", "--engine", "streaming"],
         "chunked engine"),
        (["--experiment", "x", "--fold_parallel", "2"], "add --fused"),
    ]
    for argv, match in cases:
        with pytest.raises(ValueError, match=match):
            predict_cli(argv + ["--device", "cpu"])


GAME_A = "league/challenge_a"


@pytest.fixture()
def challenge_env(tmp_path, monkeypatch, fold_ckpts):
    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path))
    rng = np.random.default_rng(0)
    for game in (GAME_A,):
        game_dir = ball.DOMAIN.soccernet_dir / game
        game_dir.mkdir(parents=True)
        for half in (1, 2):
            frames_ = [rng.integers(0, 255, (64, 96), dtype=np.uint8) for _ in range(48)]
            write_gray_store(str(game_dir / f"{half}_720p.mkv") + ".gray", frames_, 64, 96, 48)
    ckpts = {}
    for f in (0, 1):
        ckpts[f] = tmp_path / f"model-00{f}-0.50000{f}.ckpt"
        ckpts[f].write_bytes(fold_ckpts[f].read_bytes())
    return ckpts, tmp_path


def fake_info(path):
    return dict(frame_count=48, fps=25.0, width=96, height=64)


def test_pipeline_fused_matches_loop_and_jax(challenge_env):
    """predict_games_fused writes the per-fold loop's files (and JAX's), also
    on a 1×2 fold grid and a 2×1 data grid."""
    ckpts, tmp_path = challenge_env
    games = [GAME_A]
    kw = dict(video_info_fn=fake_info, device="cpu", dtype=torch.float32, chunk_size=16)
    for fold, ckpt in ckpts.items():
        predict_games(ckpt, games, ball.DOMAIN, tmp_path / "loop" / f"fold_{fold}", **kw)
    roots = {"fused": {}, "fold_par": {"fold_parallel": 2}, "data_par": {"data_parallel": 2}}
    for root, extra in roots.items():
        predict_games_fused(ckpts, games, ball.DOMAIN,
                            {f: tmp_path / root / f"fold_{f}" for f in ckpts}, **kw, **extra)
    jax_ckpts = {f: str(c) for f, c in ckpts.items()}
    jax_pipeline.predict_games_fused(
        jax_ckpts, games, jax_ball.DOMAIN, {f: tmp_path / "jax" / f"fold_{f}" for f in ckpts},
        video_info_fn=fake_info)

    for fold in ckpts:
        for game in games:
            for half in (1, 2):
                rel = f"fold_{fold}/{game}/{half}_raw_predictions.npz"
                with np.load(tmp_path / "loop" / rel) as a:
                    for root in (*roots, "jax"):
                        with np.load(tmp_path / root / rel) as b:
                            np.testing.assert_array_equal(a["frame_indexes"],
                                                          b["frame_indexes"])
                            # JAX's engine runs in bf16 by default: its own
                            # tolerance (tests/test_fused_ensemble.py)
                            atol = 2e-3 if root == "jax" else 1e-6
                            np.testing.assert_allclose(a["raw_predictions"],
                                                       b["raw_predictions"], atol=atol)
            rel = f"fold_{fold}/{game}/results_spotting.json"
            loop_json = json.loads((tmp_path / "loop" / rel).read_text())
            for root in roots:
                got = json.loads((tmp_path / root / rel).read_text())
                assert [(p["label"], p["position"]) for p in got["predictions"]] == \
                    [(p["label"], p["position"]) for p in loop_json["predictions"]]


def test_pipeline_fused_parallel_modes_exclusive(challenge_env):
    ckpts, tmp_path = challenge_env
    with pytest.raises(ValueError, match="mutually exclusive"):
        predict_games_fused(ckpts, [GAME_A], ball.DOMAIN,
                            {f: tmp_path / "x" / f"fold_{f}" for f in ckpts},
                            video_info_fn=fake_info, data_parallel=2, fold_parallel=2,
                            device="cpu")


def test_cli_fused_challenge_run(challenge_env, monkeypatch):
    """``--challenge --fused --fold_parallel 2`` through the CLI writes each
    fold's files, equal to ``--challenge`` without ``--fused``."""
    ckpts, tmp_path = challenge_env
    monkeypatch.setattr(ball, "challenge_games", [GAME_A])
    monkeypatch.setattr("ball_action_spotting_torch.core.annotations.cached_video_info",
                        fake_info)
    monkeypatch.setattr("ball_action_spotting_torch.predict.pipeline.cached_video_info",
                        fake_info)
    for fold, ckpt in ckpts.items():
        fold_dir = ball.DOMAIN.experiments_dir / "exp" / f"fold_{fold}"
        fold_dir.mkdir(parents=True)
        ckpt.rename(fold_dir / ckpt.name)
    base = ["--experiment", "exp", "--folds", "0,1", "--challenge", "--device", "cpu"]
    predict_cli(base + ["--fused", "--fold_parallel", "2"])
    out = ball.DOMAIN.predictions_dir / "exp" / "challenge"
    fused = {f: np.load(out / f"fold_{f}" / GAME_A / "1_raw_predictions.npz")["raw_predictions"]
             for f in ckpts}
    predict_cli(base)
    for f in ckpts:
        with np.load(out / f"fold_{f}" / GAME_A / "1_raw_predictions.npz") as npz:
            np.testing.assert_allclose(fused[f], npz["raw_predictions"], atol=2e-2)
        assert (out / f"fold_{f}" / GAME_A / "results_spotting.json").exists()
