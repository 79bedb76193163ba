"""Port inference path against the JAX package on the CPU: the checkpoint
reader, the chunked engine and the games pipeline, loaded from the same
JAX-written ``.ckpt``.

Tolerances: sigmoid predictions atol 1e-5 (float32 on both sides);
spotting confidences 1e-5 for the same reason. The pipeline runs in float32
on both sides so that the peak positions and labels must be identical."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ball_action_spotting_tpu.data.gray_store import write_gray_store
from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.domains import ball as jax_ball
from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.predict import pipeline as jax_pipeline
from ball_action_spotting_tpu.predict.streaming import (
    ChunkedVideoPredictor as JaxChunkedVideoPredictor,
    iter_source_frames as jax_iter_source_frames,
)
from ball_action_spotting_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint,
)
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.predict.__main__ import main as predict_cli
from ball_action_spotting_torch.predict.pipeline import predict_games
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    iter_source_frames,
)
from ball_action_spotting_torch.train.checkpoint import (
    get_best_checkpoint_path,
    load_checkpoint,
)
from ball_action_spotting_torch.train.msgpack import unpackb
from tests.test_predictor import NN_KWARGS, PARAMS  # registers the JAX tiny arch
from tests.test_torch_models import register_port_tiny_arch, to_numpy_tree

register_port_tiny_arch()

FRAME_COUNT = 40
SRC_KWARGS = dict(num_frames=FRAME_COUNT, height=64, width=96, seed=1, events={20: 0, 30: 1})
ATOL = 1e-5


def make_ckpt(path, seed: int = 3):
    """A JAX checkpoint with randomized BN statistics; the raw (non-EMA)
    tree comes from another seed, so EMA selection is visible."""
    model = jax_build_model("multidim_stacker", **NN_KWARGS)
    x = jnp.zeros((1, 6, 64, 96), jnp.float32)

    def tree(s):
        return to_numpy_tree(model.init({"params": jax.random.PRNGKey(s)}, x, train=False), s)

    save_checkpoint(path, PARAMS, tree(seed), tree(seed + 100))
    return path


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("ckpt") / "model-001-0.500000.ckpt")


def assert_trees_equal(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            assert_trees_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_msgpack_reader_matches_flax_restore():
    tree = {
        "arr": np.arange(12, dtype=np.int32).reshape(3, 4),
        "f32": np.linspace(-1, 1, 7, dtype=np.float32),
        "f64": np.asarray([1e300, -2.5]),
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"a": 1, "b": -3, "c": -70000, "d": 2**40, "e": 1.5, "f": "text",
                   "g": True, "h": None, "i": [1, 2, {"j": "k"}], "long": "x" * 300},
        "scalar": np.float32(2.0),
    }
    blob = serialization.msgpack_serialize(tree)
    expected = serialization.msgpack_restore(blob)
    restored = unpackb(blob)
    assert_trees_equal(restored, expected)
    assert restored["scalar"] == np.float32(2.0)


def test_msgpack_reader_widens_bfloat16():
    values = np.asarray([1.0, -2.5, 3.140625], np.float32)
    blob = serialization.msgpack_serialize({"w": jnp.asarray(values, jnp.bfloat16)})
    out = unpackb(blob)["w"]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, values)


@pytest.mark.parametrize("use_ema", [True, False])
def test_checkpoint_reader_matches_jax(ckpt_path, use_ema):
    variables, params = load_checkpoint(ckpt_path, use_ema=use_ema)
    expected, expected_params = jax_load_checkpoint(ckpt_path, use_ema=use_ema)
    assert params == expected_params
    assert_trees_equal(variables, expected)


def test_best_checkpoint_path(tmp_path):
    for name in ("model-001-0.500000.ckpt", "model-002-0.700000.ckpt",
                 "model-003-0.700000.ckpt", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert get_best_checkpoint_path(tmp_path).name == "model-003-0.700000.ckpt"
    assert get_best_checkpoint_path(tmp_path, tie_keep="first").name == \
        "model-002-0.700000.ckpt"
    assert get_best_checkpoint_path(tmp_path / "missing") is None


def test_synthetic_source_matches_jax():
    port = SyntheticSource(**SRC_KWARGS)
    ref = JaxSyntheticSource(**SRC_KWARGS)
    for _ in range(FRAME_COUNT):
        np.testing.assert_array_equal(port.fetch_frame(), ref.fetch_frame())


@pytest.mark.parametrize("carry_features", [True, False])
@pytest.mark.parametrize("tta", [False, True])
def test_chunked_predictor_matches_jax(ckpt_path, carry_features, tta):
    chunk = 16 if tta else 10
    jax_engine = JaxChunkedVideoPredictor(ckpt_path, tta=tta, dtype=jnp.float32,
                                          chunk_size=chunk, carry_features=carry_features)
    j_idx, j_raw = jax_engine.predict_video(
        jax_iter_source_frames(JaxSyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    engine = ChunkedVideoPredictor(ckpt_path, tta=tta, dtype=torch.float32,
                                   chunk_size=chunk, carry_features=carry_features,
                                   device="cpu")
    idx, raw = engine.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)),
                                    FRAME_COUNT)
    assert list(idx) == list(j_idx) and idx[0] == 7 and idx[-1] == 34
    assert raw.shape == (28, 2) and raw.dtype == np.float32
    np.testing.assert_allclose(raw, j_raw, atol=ATOL)


def test_chunked_predictor_raw_weights_and_short_video(ckpt_path):
    """use_ema=False loads the raw tree; a video shorter than one window
    gives no predictions."""
    _, j_raw = JaxChunkedVideoPredictor(
        ckpt_path, use_ema=False, dtype=jnp.float32, chunk_size=10).predict_video(
        jax_iter_source_frames(JaxSyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    engine = ChunkedVideoPredictor(ckpt_path, use_ema=False, dtype=torch.float32,
                                   chunk_size=10, device="cpu")
    idx, raw = engine.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)),
                                    FRAME_COUNT)
    np.testing.assert_allclose(raw, j_raw, atol=ATOL)
    idx, raw = engine.predict_video(
        iter_source_frames(SyntheticSource(num_frames=8, height=64, width=96)), 8)
    assert idx == [] and raw.shape == (0, 2)


GAME = "league/testgame"
FRAMES = 60


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """Gray stores standing in for two halves' videos, as the JAX pipeline
    tests use them, and a JAX checkpoint."""
    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path))
    rng = np.random.default_rng(0)
    for game in (GAME, *ball.fold2games[0]):
        game_dir = ball.DOMAIN.soccernet_dir / game
        game_dir.mkdir(parents=True)
        for half in (1, 2):
            frames = [rng.integers(0, 255, (64, 96), dtype=np.uint8) for _ in range(FRAMES)]
            video = game_dir / f"{half}_720p.mkv"
            write_gray_store(str(video) + ".gray", frames, 64, 96, FRAMES)
            (game_dir / f"{half}_720p.mkv.info.json").write_text(json.dumps(
                dict(frame_count=FRAMES, fps=25.0, width=96, height=64)))
    return tmp_path, make_ckpt(tmp_path / "model-001-0.900000.ckpt")


def fake_info(path):
    return dict(frame_count=FRAMES, fps=25.0, width=96, height=64)


def test_predict_games_matches_jax_pipeline(workdir):
    tmp_path, ckpt = workdir
    jax_dir, port_dir, saved_dir = tmp_path / "jax", tmp_path / "port", tmp_path / "saved"
    jax_engine = JaxChunkedVideoPredictor(ckpt, dtype=jnp.float32, chunk_size=16)
    jax_pipeline.predict_game(jax_engine, GAME, jax_ball.DOMAIN, jax_dir,
                              video_info_fn=fake_info)
    predict_games(ckpt, [GAME], ball.DOMAIN, port_dir, video_info_fn=fake_info,
                  device="cpu", dtype=torch.float32, chunk_size=16)

    for half in (1, 2):
        rel = f"{GAME}/{half}_raw_predictions.npz"
        with np.load(jax_dir / rel) as a, np.load(port_dir / rel) as b:
            np.testing.assert_array_equal(a["frame_indexes"], b["frame_indexes"])
            np.testing.assert_allclose(b["raw_predictions"], a["raw_predictions"], atol=ATOL)
    rel = f"{GAME}/results_spotting.json"
    expected = json.loads((jax_dir / rel).read_text())
    got = json.loads((port_dir / rel).read_text())
    assert got["UrlLocal"] == expected["UrlLocal"] == GAME
    assert len(got["predictions"]) == len(expected["predictions"]) > 0
    for p, q in zip(got["predictions"], expected["predictions"]):
        assert {k: p[k] for k in ("gameTime", "label", "position", "half")} == \
            {k: q[k] for k in ("gameTime", "label", "position", "half")}
        assert abs(float(p["confidence"]) - float(q["confidence"])) <= ATOL
    assert (port_dir / GAME / "postprocess_params.json").read_text() == \
        (jax_dir / GAME / "postprocess_params.json").read_text()

    # the same raw predictions give the same file, byte for byte
    for half in (1, 2):
        rel = f"{GAME}/{half}_raw_predictions.npz"
        (saved_dir / GAME).mkdir(parents=True, exist_ok=True)
        (saved_dir / rel).write_bytes((jax_dir / rel).read_bytes())
    predict_games(None, [GAME], ball.DOMAIN, saved_dir, use_saved=True,
                  video_info_fn=fake_info)
    assert (saved_dir / rel.replace("2_raw_predictions.npz", "results_spotting.json")
            ).read_text() == (jax_dir / GAME / "results_spotting.json").read_text()


def test_predict_cli_runs_a_fold(workdir):
    tmp_path, ckpt = workdir
    fold_dir = ball.DOMAIN.experiments_dir / "exp" / "fold_0"
    fold_dir.mkdir(parents=True)
    ckpt.rename(fold_dir / ckpt.name)
    predict_cli(["--experiment", "exp", "--folds", "0", "--device", "cpu"])
    out = ball.DOMAIN.predictions_dir / "exp" / "cv" / "fold_0" / ball.fold2games[0][0]
    with np.load(out / "1_raw_predictions.npz") as npz:
        raw = npz["raw_predictions"]
    assert raw.shape == (FRAMES - 12, 2) and np.isfinite(raw).all()
    assert json.loads((out / "results_spotting.json").read_text())["UrlLocal"] == \
        ball.fold2games[0][0]
