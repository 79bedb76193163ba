"""The port's per-frame streaming engine against the JAX package's on the
CPU: ``StreamingPredictor`` + ``get_raw_predictions`` from the same
JAX-written ``.ckpt``, the games pipeline with ``engine="streaming"`` and
both predict CLIs with ``--engine streaming``.

Tolerances: sigmoid predictions atol 1e-5 (float32 on both sides, as
``tests/test_torch_predict.py``); the streaming engine against the chunked
engine of the port also 1e-5, since the two normalize and pool in other
orders (float32 then the compute dtype, the concatenated stack map against
each stack). The CLIs run the model in bf16, their default, so the CLIs'
two engines are held within the card's bf16 tolerance, 0.02."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.domains import ball as jax_ball
from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.predict import pipeline as jax_pipeline
from ball_action_spotting_tpu.predict.streaming import (
    StreamingPredictor as JaxStreamingPredictor,
    get_raw_predictions as jax_get_raw_predictions,
)
from ball_action_spotting_tpu.train.checkpoint import save_checkpoint
from ball_action_spotting_torch.cli import action_predict
from ball_action_spotting_torch.data.gray_store import write_gray_store
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import action, ball
from ball_action_spotting_torch.predict.__main__ import main as ball_predict_cli
from ball_action_spotting_torch.predict.pipeline import make_predictor, predict_games
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    StreamingPredictor,
    get_raw_predictions,
    iter_source_frames,
)
from tests.test_predictor import NN_KWARGS, PARAMS
from tests.test_torch_models import to_numpy_tree
from tests.test_torch_predict import (  # noqa: F401  (workdir is a fixture)
    FRAME_COUNT,
    FRAMES,
    GAME,
    SRC_KWARGS,
    fake_info,
    make_ckpt,
    workdir,
)

ATOL = 1e-5
CLI_BF16_ATOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny arch gains nothing from intra-op threads, and beside the
    suite's other workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("ckpt") / "model-001-0.500000.ckpt")


def port_streaming(ckpt, **kwargs):
    return StreamingPredictor(ckpt, dtype=torch.float32, device="cpu", **kwargs)


@pytest.mark.parametrize("tta", [False, True])
def test_streaming_predictor_matches_jax(ckpt_path, tta):
    j_idx, j_raw = jax_get_raw_predictions(
        JaxStreamingPredictor(ckpt_path, tta=tta, dtype=jnp.float32),
        JaxSyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    idx, raw = get_raw_predictions(port_streaming(ckpt_path, tta=tta),
                                   SyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    assert idx == j_idx and idx[0] == 7 and idx[-1] == 34
    assert raw.shape == (28, 2) and raw.dtype == np.float32
    np.testing.assert_allclose(raw, j_raw, atol=ATOL)


def test_streaming_predict_returns_device_rows_and_none_until_the_window_fills(ckpt_path):
    engine = port_streaming(ckpt_path)
    src = SyntheticSource(**SRC_KWARGS)
    outs = [engine.predict(src.fetch_frame(), i) for i in range(15)]
    # the window of predict index p is frames p-6 .. p+4, step 2
    assert [p is None for p, _ in outs] == [True] * 10 + [False] * 5
    assert [pi for _, pi in outs] == [i - 4 for i in range(15)]
    pred = outs[-1][0]
    assert isinstance(pred, torch.Tensor) and pred.shape == (2,) and pred.dtype == torch.float32
    # entries older than the window are evicted; the window's stacks stay
    assert min(engine._frame_index2frame) == 14 - 10
    stacks = engine._stack_indexes2features
    assert min(min(k) for k in stacks) == 4 and {(4, 6, 8), (10, 12, 14)} <= set(stacks)


@pytest.mark.parametrize("tta", [False, True])
def test_streaming_matches_chunked(ckpt_path, tta):
    idx, raw = get_raw_predictions(port_streaming(ckpt_path, tta=tta),
                                   SyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    chunked = ChunkedVideoPredictor(ckpt_path, tta=tta, dtype=torch.float32, chunk_size=10,
                                    device="cpu")
    c_idx, c_raw = chunked.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)),
                                         FRAME_COUNT)
    assert idx == list(c_idx)
    np.testing.assert_allclose(raw, c_raw, atol=ATOL)


def test_short_video_returns_empty(ckpt_path):
    idx, raw = get_raw_predictions(port_streaming(ckpt_path),
                                   SyntheticSource(num_frames=8, height=64, width=96), 8)
    assert idx == [] and raw.shape == (0, 2) and raw.dtype == np.float32


def test_make_predictor_engines(ckpt_path):
    assert type(make_predictor(ckpt_path, engine="streaming", device="cpu")) is StreamingPredictor
    assert type(make_predictor(ckpt_path, device="cpu")) is ChunkedVideoPredictor
    with pytest.raises(ValueError, match="Unknown engine"):
        make_predictor(ckpt_path, engine="fused", device="cpu")


def test_predict_games_streaming_matches_jax_pipeline(workdir):  # noqa: F811
    tmp_path, ckpt = workdir
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_engine = jax_pipeline.make_predictor(ckpt, engine="streaming", dtype=jnp.float32)
    jax_pipeline.predict_game(jax_engine, GAME, jax_ball.DOMAIN, jax_dir,
                              video_info_fn=fake_info)
    predict_games(ckpt, [GAME], ball.DOMAIN, port_dir, engine="streaming",
                  video_info_fn=fake_info, device="cpu", dtype=torch.float32)
    for half in (1, 2):
        rel = f"{GAME}/{half}_raw_predictions.npz"
        with np.load(jax_dir / rel) as a, np.load(port_dir / rel) as b:
            np.testing.assert_array_equal(a["frame_indexes"], b["frame_indexes"])
            np.testing.assert_allclose(b["raw_predictions"], a["raw_predictions"], atol=ATOL)
    rel = f"{GAME}/results_spotting.json"
    expected = json.loads((jax_dir / rel).read_text())["predictions"]
    got = json.loads((port_dir / rel).read_text())["predictions"]
    assert len(got) == len(expected) > 0
    for p, q in zip(got, expected):
        assert {k: p[k] for k in ("gameTime", "label", "position", "half")} == \
            {k: q[k] for k in ("gameTime", "label", "position", "half")}
        assert abs(float(p["confidence"]) - float(q["confidence"])) <= ATOL


def action_ckpt(path):
    """A JAX checkpoint of the tiny arch with the action domain's 15 classes."""
    kwargs = dict(NN_KWARGS, num_classes=len(action.classes))
    model = jax_build_model("multidim_stacker", **kwargs)
    variables = to_numpy_tree(model.init({"params": jax.random.PRNGKey(5)},
                                         jnp.zeros((1, 6, 64, 96), jnp.float32), train=False), 5)
    save_checkpoint(path, dict(PARAMS, nn_module=("multidim_stacker", kwargs)), variables)
    return path


def test_predict_clis_with_the_streaming_engine(workdir, monkeypatch):  # noqa: F811
    """Both predict CLIs with ``--engine streaming --device cpu`` write the
    raw npz that ``--engine chunked`` writes, within the bf16 tolerance."""
    tmp_path, ckpt = workdir
    monkeypatch.setattr("ball_action_spotting_torch.predict.pipeline.cached_video_info",
                        fake_info)
    fold_dir = ball.DOMAIN.experiments_dir / "exp" / "fold_0"
    fold_dir.mkdir(parents=True)
    ckpt.rename(fold_dir / ckpt.name)

    game = "league/action_game"
    rng = np.random.default_rng(1)
    for half in (1, 2):
        video = action.DOMAIN.soccernet_dir / game / f"{half}_720p.mkv"
        video.parent.mkdir(parents=True, exist_ok=True)
        write_gray_store(str(video) + ".gray",
                         [rng.integers(0, 255, (64, 96), dtype=np.uint8) for _ in range(FRAMES)],
                         64, 96, FRAMES)
    (tmp_path / "splits").mkdir()
    (tmp_path / "splits" / "val.json").write_text(json.dumps([game]))
    monkeypatch.setenv("BAS_TPU_ACTION_SPLITS", str(tmp_path / "splits"))
    action_ckpt(action.DOMAIN.experiments_dir / "act" / "model-001-0.500000.ckpt")

    outputs = {}
    for engine in ("chunked", "streaming"):
        ball_predict_cli(["--experiment", "exp", "--folds", "0", "--engine", engine,
                          "--device", "cpu"])
        action_predict.main(["--experiment", "act", "--engine", engine, "--device", "cpu"])
        for name, path in (
                ("ball", ball.DOMAIN.predictions_dir / "exp" / "cv" / "fold_0"
                 / ball.fold2games[0][0] / "1_raw_predictions.npz"),
                ("action", action.DOMAIN.predictions_dir / "act" / "val" / game
                 / "1_raw_predictions.npz")):
            with np.load(path) as npz:
                outputs[engine, name] = (npz["frame_indexes"], npz["raw_predictions"])
    for name, classes in (("ball", 2), ("action", len(action.classes))):
        c_idx, c_raw = outputs["chunked", name]
        s_idx, s_raw = outputs["streaming", name]
        assert s_raw.shape == (FRAMES - 12, classes) and np.isfinite(s_raw).all()
        np.testing.assert_array_equal(s_idx, c_idx)
        np.testing.assert_allclose(s_raw, c_raw, atol=CLI_BF16_ATOL)
