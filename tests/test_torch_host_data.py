"""The rest of the host data layer on the CPU, each held to the JAX package on the same
seeded inputs: ``HardSyntheticSource`` bitwise, ``smooth_scores_batch``
(float32 on a device) within 1e-6 of JAX's and 2e-3 of scipy, profiling,
and the ``verify_data`` and ``visualize`` CLIs."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter1d

from ball_action_spotting_tpu.core.postprocess import gaussian_kernel1d as jax_kernel
from ball_action_spotting_tpu.core.postprocess import smooth_scores_batch as jax_smooth
from ball_action_spotting_tpu.data.video import HardSyntheticSource as JaxHard
from ball_action_spotting_tpu.data.gray_store import write_gray_store as jax_write_gray_store
from ball_action_spotting_torch.cli import verify_data, visualize
from ball_action_spotting_torch.core.postprocess import gaussian_kernel1d, smooth_scores_batch
from ball_action_spotting_torch.core.spotting import save_raw_predictions
from ball_action_spotting_torch.data import HardSyntheticSource
from ball_action_spotting_torch.data.gray_store import store_path_for_video, write_gray_store
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.utils import profiling
from ball_action_spotting_torch.utils.profiling import device_trace, synchronize
from scripts import verify_data as jax_verify_data

# --- HardSyntheticSource ------------------------------------------------------

HARD_CASES = [
    dict(num_frames=120, height=64, width=96, seed=0, events={30: 0, 70: 1}),
    dict(num_frames=90, height=48, width=80, seed=7, events={20: 1, 45: 0, 60: 1},
         signal=0.8, noise=30, distractor_rate=1.0, event_window=7),
    dict(num_frames=60, height=72, width=40, seed=3, events={}, signal=0.2, noise=1),
    dict(num_frames=150, height=64, width=96, seed=11, events={25: 0, 100: 0},
         distractor_rate=2.0),
]


@pytest.mark.parametrize("case", range(len(HARD_CASES)))
def test_hard_synthetic_render_all_is_bitwise_jax(case):
    kwargs = HARD_CASES[case]
    ours, theirs = HardSyntheticSource(**kwargs), JaxHard(**kwargs)
    assert ours._movers == theirs._movers
    frames = ours.render_all()
    assert frames.shape == (kwargs["num_frames"], kwargs["height"], kwargs["width"])
    assert frames.dtype == np.uint8 and frames.tobytes() == theirs.render_all().tobytes()
    # a seek equals the sequential render
    for index in (kwargs["num_frames"] - 1, 5, 6, 0):
        np.testing.assert_array_equal(ours.fetch_frame(index), frames[index])
    np.testing.assert_array_equal(ours.fetch_frames([2, 4, 9]), frames[[2, 4, 9]])


# --- smoothing ----------------------------------------------------------------

SMOOTH_CASES = {
    "classes_by_frames": ((3, 400), 3.0),
    "one_row": ((400,), 3.0),
    "row_shorter_than_the_radius": ((2, 5), 3.0),
    "single_frame": ((1, 1), 1.5),
    "wide_sigma": ((2, 64), 20.0),
}


@pytest.mark.parametrize("case", sorted(SMOOTH_CASES))
def test_smooth_scores_batch_equals_jax_and_scipy(case):
    shape, sigma = SMOOTH_CASES[case]
    scores = np.random.default_rng(len(case)).random(shape).astype(np.float32)
    ours = smooth_scores_batch(scores, gauss_sigma=sigma, device="cpu")
    assert ours.shape == shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, jax_smooth(scores, gauss_sigma=sigma), rtol=0, atol=1e-6)
    ref = gaussian_filter1d(scores.astype(np.float64), sigma, axis=-1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(gaussian_kernel1d(sigma), jax_kernel(sigma))


def test_smooth_scores_batch_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smooth_scores_batch(np.zeros((2, 10), np.float32), 3.0)


# --- profiling ----------------------------------------------------------------

def test_stage_timer_accumulates():
    """The tracer's per-name totals and report, which took ``StageTimer``'s
    place."""
    profiling.reset()
    profiling.enable()
    try:
        for _ in range(3):
            with profiling.span("stage.decode"):
                pass
        with profiling.span("stage.collate"):
            pass
        with profiling.span("other"):
            pass
    finally:
        profiling.disable()
    records = profiling.records()
    totals = records.totals("stage.")
    assert {name: n for name, (_, n) in totals.items()} == {"stage.decode": 3, "stage.collate": 1}
    assert all(secs >= 0 for secs, _ in totals.values())
    report = records.report("stage.")
    assert "stage.decode" in report and "ms/call" in report and "other" not in report
    assert report.splitlines()[0].split(":")[0] in ("stage.decode", "stage.collate")
    profiling.reset()
    assert not profiling.records().spans and not profiling.records().totals()


def test_synchronize_tolerates_trees():
    synchronize({"a": torch.ones(4), "b": {"c": [torch.zeros(2, 2), (torch.zeros(1), 3)]}})
    synchronize({})
    synchronize(None)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace") as path:
        torch.nn.functional.conv1d(torch.ones(1, 1, 32), torch.ones(1, 1, 3)).sum()
    assert path.parent == tmp_path / "trace" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("conv1d" in e.get("name", "") for e in events)


# --- verify_data --------------------------------------------------------------

GAME = "league/2020/test-game"


def make_game(root, labels=None, halves=(1, 2), with_store=False, writer=write_gray_store):
    """``tests/test_verify_data.py``'s workdir, its stores written by ``writer``."""
    game_dir = root / GAME
    game_dir.mkdir(parents=True, exist_ok=True)
    if labels is None:
        labels = {"annotations": [
            {"gameTime": "1 - 00:04", "label": "PASS", "position": "4000"},
            {"gameTime": "2 - 00:08", "label": "DRIVE", "position": "8000"},
        ]}
    (game_dir / "Labels-ball.json").write_text(json.dumps(labels))
    for half in halves:
        video = game_dir / f"{half}_720p.mkv"
        video.write_bytes(b"\x00fake video bytes")
        if with_store:
            frames = (np.zeros((8, 12), np.uint8) for _ in range(4))
            writer(store_path_for_video(video), frames, 8, 12, 4)
    return game_dir


def fake_info(path):
    return dict(frame_count=500, fps=25.0, width=1280, height=720)


def fps30(path):
    return dict(frame_count=500, fps=30.0, width=1280, height=720)


def flaky_info(path):
    if path.endswith("2_720p.mkv"):
        raise RuntimeError("cannot open")
    return fake_info(path)


LATE = {"annotations": [{"gameTime": "1 - 01:00", "label": "PASS", "position": "60000"}]}
BAD = {"annotations": [
    {"gameTime": "1 - 00:04", "label": "PASS", "position": "4000"},
    {"gameTime": "3 - 00:04", "label": "PASS", "position": "4000"},
    {"gameTime": "1 - 00:05", "label": "Goal", "position": "5000"},
    {"gameTime": "junk", "label": "PASS", "position": "x"},
    {"gameTime": "1 - 00:06", "label": "PASS", "position": "-40"},
]}
# each workdir: make_game kwargs (None: no soccernet dir), and the probe
WORKDIRS = {
    "ready": (dict(with_store=True), fake_info),
    "no_soccernet_dir": (None, fake_info),
    "missing_half_no_stores": (dict(halves=(1,)), fake_info),
    "annotation_past_the_end": (dict(labels=LATE, with_store=True), fake_info),
    "fps_mismatch": (dict(with_store=True), fps30),
    "no_probe": (dict(with_store=True), None),
    "bad_annotations": (dict(labels=BAD, with_store=True), fake_info),
    "empty_annotations": (dict(labels={"annotations": []}), fake_info),
    "no_annotations": (dict(labels={}), None),
    "unprobeable_half": (dict(with_store=True), flaky_info),
}


def _issues(report, work):
    """(level, game, message) with the workdir and JAX's transcode hint
    written as the port's."""
    return [(i.level, i.game, i.message.replace(str(work), "<work>")
             .replace("scripts/transcode.py", verify_data.TRANSCODE))
            for i in report["issues"]]


@pytest.mark.parametrize("name", sorted(WORKDIRS))
def test_verify_workdir_reports_equal_jax(name, tmp_path, monkeypatch):
    kwargs, info_fn = WORKDIRS[name]
    reports = {}
    for package, module, writer in (("port", verify_data, write_gray_store),
                                    ("jax", jax_verify_data, jax_write_gray_store)):
        monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path / package))
        if kwargs is not None:
            make_game(ball.DOMAIN.soccernet_dir, writer=writer, **kwargs)
        reports[package] = module.verify_workdir(ball.DOMAIN, games=[GAME, "other/game"],
                                                 video_info_fn=info_fn)
    ours, theirs = reports["port"], reports["jax"]
    assert _issues(ours, tmp_path / "port") == _issues(theirs, tmp_path / "jax")
    for key in ("ready", "missing_store_bytes", "games_checked", "domain"):
        assert ours[key] == theirs[key], key
    assert ours["issues"] or name == "ready"


@pytest.mark.parametrize("argv", [
    ["--games", GAME, "--no-probe"],
    ["--games", GAME, "other/game", "--no-probe"],
    ["--games", GAME, "--no-probe", "--strict"],
    ["--games", GAME, "--resolution", "224p", "--no-probe"],
])
def test_verify_data_main_exit_codes_equal_jax(argv, tmp_path, monkeypatch, capsys):
    results = {}
    for package, module, writer in (("port", verify_data, write_gray_store),
                                    ("jax", jax_verify_data, jax_write_gray_store)):
        monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path / package))
        make_game(ball.DOMAIN.soccernet_dir, halves=(1, 2), with_store=True, writer=writer)
        (ball.DOMAIN.soccernet_dir / GAME / "2_720p.mkv.gray").unlink()  # a warning
        rc = module.main(["--domain", "ball_action", *argv])
        out = capsys.readouterr().out.splitlines()
        results[package] = (rc, out[-1], sum(line.startswith("[") for line in out))
    assert results["port"] == results["jax"]


def test_verify_data_without_cv2_skips_the_probe(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path))
    make_game(ball.DOMAIN.soccernet_dir, with_store=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    rc = verify_data.main(["--domain", "ball_action", "--games", GAME])
    out = capsys.readouterr().out
    assert rc == 0 and "skipping the video probe" in out and out.rstrip().endswith("READY")


# --- visualize ----------------------------------------------------------------

def test_visualize_writes_a_video_per_half(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path))
    h, w, n = 64, 96, 40
    game = ball.fold2games[0][0]
    game_dir = ball.DOMAIN.soccernet_dir / game
    pred_dir = ball.DOMAIN.predictions_dir / "exp" / "cv" / "fold_0" / game
    rng = np.random.default_rng(0)
    annotations = []
    for half in (1, 2):
        video = game_dir / f"{half}_720p.mkv"
        write_gray_store(store_path_for_video(video),
                         iter(rng.integers(0, 256, (n, h, w), dtype=np.uint8)), h, w, n)
        Path(str(video) + ".info.json").write_text(
            json.dumps(dict(frame_count=n, fps=25.0, width=w, height=h)))
        annotations.append({"gameTime": f"{half} - 00:01", "label": "PASS", "position": "1000"})
        save_raw_predictions(pred_dir / f"{half}_raw_predictions.npz", np.arange(5, n - 5),
                             rng.random((n - 10, 2)).astype(np.float32))
    (game_dir / "Labels-ball.json").write_text(json.dumps({"annotations": annotations}))

    visualize.main(["--experiment", "exp", "--folds", "0"])
    out_dir = ball.DOMAIN.visualizations_dir / "exp" / game
    for half in (1, 2):
        cap = cv2.VideoCapture(str(out_dir / f"{half}_visualization.avi"))
        frames = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            assert frame.shape == (h + visualize.GRAPH_HEIGHT * 2, w, 3)
            frames += 1
        cap.release()
        assert frames == n

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        visualize.main(["--experiment", "exp", "--folds", "0"])
