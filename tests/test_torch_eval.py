"""The port's evaluation (``eval/soccernet_map.py``, ``eval/official_map.py``,
``eval/submission.py``), the ``core/spotting.py`` read and blend helpers and
the ball ensemble, submission and evaluate CLIs against the JAX package on
the CPU, on the fixtures of ``tests/test_eval_map.py``,
``tests/test_eval_official.py``, ``tests/test_official_oracle.py``,
``tests/test_evaluate_games.py``, ``tests/test_submission.py`` and
``tests/test_ensemble.py``, with zipped labels and zipped predictions among
them. Then one JAX-written ``.ckpt`` predicts one synthetic game through
each package's pipeline and each package's evaluate CLI scores it.

Tolerances: numpy on both sides in the same order, so integers, labels,
structure and files must be equal and floats within 1e-12; raw predictions
of the two predict pipelines (float32 models) within 1e-4, and their a_mAP@1
within 1e-6."""

import importlib.util
import json
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.core import spotting as jax_spotting
from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.domains import action as jax_action
from ball_action_spotting_tpu.domains import ball as jax_ball
from ball_action_spotting_tpu.eval import official_map as jax_official
from ball_action_spotting_tpu.eval import soccernet_map as jax_map
from ball_action_spotting_tpu.eval import submission as jax_submission
from ball_action_spotting_tpu.predict import pipeline as jax_pipeline
from ball_action_spotting_tpu.predict.streaming import (
    ChunkedVideoPredictor as JaxChunkedVideoPredictor,
)
from ball_action_spotting_torch.cli import ball_ensemble, ball_evaluate, ball_make_submission
from ball_action_spotting_torch.core import spotting
from ball_action_spotting_torch.data.gray_store import write_gray_store
from ball_action_spotting_torch.domains import action, ball
from ball_action_spotting_torch.eval import official_map, soccernet_map, submission
from ball_action_spotting_torch.predict.pipeline import predict_games
from tests.test_eval_official import _random_case
from tests.test_torch_predict import make_ckpt

ROOT = Path(__file__).resolve().parents[1]
FLOAT_TOL = 1e-12
DOMAINS = {"ball": (ball.DOMAIN, jax_ball.DOMAIN), "action": (action.DOMAIN, jax_action.DOMAIN)}


def assert_same(got, want, where="result"):
    """Equal structure, integers, strings and flags; floats within 1e-12."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for key in want:
            assert_same(got[key], want[key], f"{where}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, where
        assert got.dtype == want.dtype, where
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, (float, np.floating)):
        assert isinstance(got, (float, np.floating)), where
        assert abs(float(got) - float(want)) <= FLOAT_TOL, (where, got, want)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


# --------------------------------------------------- spot-level matcher ---

MATCH_CASES = [
    ([100], [(105, 0.9)], 12.5),
    ([100], [(120, 0.9)], 12.5),
    ([100], [(98, 0.4), (103, 0.8)], 12.5),
    ([100, 110], [(101, 0.9), (109, 0.5)], 12.5),
    ([110, 100], [(109, 0.5), (101, 0.9), (300, 0.7)], 25.0),
    ([], [(5, 0.1)], 12.5),
    ([50], [], 12.5),
]


@pytest.mark.parametrize("gt, preds, window", MATCH_CASES)
def test_match_spots_equals_jax(gt, preds, window):
    assert_same(soccernet_map.match_spots(gt, preds, window),
                jax_map.match_spots(gt, preds, window))


AP_CASES = [
    (np.array([[0.9, 1.0], [0.8, 1.0]]), 2),
    (np.array([[0.9, 0.0], [0.8, 0.0]]), 2),
    (np.array([[0.9, 1.0]]), 2),
    (np.array([[1.0, 1.0]] * 3), 10),  # recall exactly 0.3: the 11-point grid's boundary
    (np.zeros((0, 2)), 3),
    (np.array([[0.5, 1.0], [0.5, 0.0], [0.2, 1.0]]), 0),
]


@pytest.mark.parametrize("case", range(len(AP_CASES)))
def test_average_precision_and_curves_equal_jax(case):
    dets, total_gt = AP_CASES[case]
    assert_same(soccernet_map.average_precision(dets, total_gt),
                jax_map.average_precision(dets, total_gt))
    if len(dets):
        curves = official_map._threshold_curves(dets, total_gt)
        assert_same(curves, jax_official._threshold_curves(dets, total_gt))
        assert_same(official_map._ap_from_curve(*curves), jax_official._ap_from_curve(*curves))


AVERAGE_MAP_CASES = [
    ([{"A": [100, 200], "B": [150]}], [{"A": [(100, 0.9), (201, 0.8)], "B": [(400, 0.7)]}]),
    ([{"A": [100], "B": []}], [{"A": [(100, 0.9)], "B": []}]),
    ([{"A": [10, 400], "B": [30]}, {"A": [], "B": [99]}],
     [{"A": [(12, 0.3), (405, 0.6), (700, 0.9)]}, {"B": [(90, 0.4), (101, 0.8)]}]),
]


@pytest.mark.parametrize("case", range(len(AVERAGE_MAP_CASES)))
@pytest.mark.parametrize("metric", ["at1", "tight", "loose"])
def test_average_map_equals_jax(case, metric):
    gt, pred = AVERAGE_MAP_CASES[case]
    deltas = soccernet_map.METRIC_DELTAS[metric]
    np.testing.assert_array_equal(deltas, jax_map.METRIC_DELTAS[metric])
    assert_same(soccernet_map.average_map(gt, pred, ["A", "B"], 25.0, deltas),
                jax_map.average_map(gt, pred, ["A", "B"], 25.0, deltas))


def test_metric_deltas_equal_jax():
    assert list(soccernet_map.METRIC_DELTAS) == list(jax_map.METRIC_DELTAS)
    for key, value in jax_map.METRIC_DELTAS.items():
        assert_same(soccernet_map.METRIC_DELTAS[key], value)


# ---------------------------------------------------- official pipeline ---

def _ann(half, pos_ms, label, visibility=None):
    total_s = pos_ms // 1000
    ann = {"gameTime": f"{half} - {total_s // 60:02d}:{total_s % 60:02d}",
           "label": label, "position": str(pos_ms)}
    if visibility:
        ann["visibility"] = visibility
    return ann


def _pred(half, pos_ms, label, conf):
    return {"half": half, "position": str(pos_ms), "label": label, "confidence": conf}


# JSON vectorization: truncation (999 ms), collisions on one frame, the
# 90-minute clamp, unknown labels, "not shown" signs, the three card classes
# merged into "Card" and "Yellow card" predictions mapped back to it.
VECTOR_CASES = {
    "ball": (
        [_ann(1, 999, "PASS"), _ann(1, 10000, "PASS"), _ann(1, 10020, "PASS"),
         _ann(1, 10400, "DRIVE", "not shown"), _ann(2, 4800000, "PASS"),
         _ann(2, 95 * 60 * 1000, "DRIVE"), _ann(1, 1000, "NotAClass"), _ann(3, 1000, "PASS")],
        [_pred(1, 10440, "PASS", 0.9), _pred(2, 4799999, "PASS", 0.5),
         _pred(2, 9999999, "DRIVE", 0.25), _pred(1, 500, "Goal", 0.3)],
    ),
    "action": (
        [_ann(1, 10000, "Yellow card", "visible"), _ann(1, 20000, "Red card", "not shown"),
         _ann(2, 30000, "Yellow->red card", "visible"), _ann(2, 40000, "Goal", "not shown"),
         _ann(1, 134480, "Corner", "visible")],
        [_pred(1, 10000, "Yellow card", 0.9), _pred(2, 30040, "Yellow card", 0.4),
         _pred(1, 134480, "Corner", 0.7), _pred(2, 40000, "Goal", 0.2)],
    ),
}


@pytest.mark.parametrize("domain_name", ["ball", "action"])
def test_official_vectors_equal_jax(domain_name):
    port_domain, jax_domain = DOMAINS[domain_name]
    anns, preds = VECTOR_CASES[domain_name]
    labels, predictions = {"annotations": anns}, {"predictions": preds}
    assert official_map.vector_size(25.0) == jax_official.vector_size(25.0)
    got_l = official_map.label_vectors(labels, port_domain, 25.0)
    got_p = official_map.prediction_vectors(predictions, port_domain, 25.0)
    assert_same(got_l, jax_official.label_vectors(labels, jax_domain, 25.0))
    assert_same(got_p, jax_official.prediction_vectors(predictions, jax_domain, 25.0))
    for half in port_domain.halves:
        assert_same(official_map.closest_vector(got_l[half]),
                    jax_official.closest_vector(got_l[half]))
    for half in port_domain.halves:
        for vis in (None, "visible", "not shown"):
            assert_same(soccernet_map.spots_from_labels(labels, port_domain, half, 25.0, vis),
                        jax_map.spots_from_labels(labels, jax_domain, half, 25.0, vis))
        assert_same(soccernet_map.spots_from_predictions(predictions, port_domain, half, 25.0),
                    jax_map.spots_from_predictions(predictions, jax_domain, half, 25.0))


def _random_half(rng, size, num_classes, n_gt=18, n_pred=60, p_unshown=0.25):
    """``tests/test_official_oracle.py``'s random dense half."""
    target = np.zeros((size, num_classes))
    det = np.zeros((size, num_classes)) - 1
    for c in range(num_classes):
        for f in rng.choice(size, size=rng.integers(0, n_gt), replace=False):
            target[f, c] = -1.0 if rng.random() < p_unshown else 1.0
        pred_frames = rng.choice(size, size=rng.integers(1, n_pred), replace=False)
        det[pred_frames, c] = np.round(rng.random(len(pred_frames)), 3)
    return target, det


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_average_map_official_equals_jax_on_random_dense_vectors(seed):
    rng = np.random.default_rng(seed)
    targets, dets = zip(*[_random_half(rng, 700, 3) for _ in range(6)])
    closests = [official_map.closest_vector(t) for t in targets]
    for t, c in zip(targets, closests):
        assert_same(c, jax_official.closest_vector(t))
    for c in range(3):
        for delta in (25.0, 75.0):
            assert_same(official_map.match_class_scores(targets[0][:, c], closests[0][:, c],
                                                        dets[0][:, c], delta),
                        jax_official.match_class_scores(targets[0][:, c], closests[0][:, c],
                                                        dets[0][:, c], delta))
    deltas = np.arange(5) + 1
    assert_same(official_map.average_map_official(targets, dets, closests, 25.0, deltas),
                jax_official.average_map_official(targets, dets, closests, 25.0, deltas))


# ------------------------------------------------------- evaluate_games ---

def _ball_perfect():
    anns = [_ann(1, 10000, "PASS"), _ann(1, 20000, "DRIVE"), _ann(2, 10000, "PASS")]
    preds = [_pred(1, 10000, "PASS", 0.9), _pred(1, 20000, "DRIVE", 0.8),
             _pred(2, 10040, "PASS", 0.7)]
    return "ball", [("league/g1", anns, preds)]


def _ball_absent_class():
    return "ball", [("league/g0", [_ann(1, 10000, "PASS")], [_pred(1, 10000, "PASS", 0.9)])]


def _action_visibility():
    anns = [_ann(1, 10000, "Goal", "visible"), _ann(1, 30000, "Goal", "not shown")]
    return "action", [("league/g2", anns, [_pred(1, 10000, "Goal", 0.9)])]


def _ball_random(seed):
    return "ball", _random_case(np.random.default_rng(seed))


def _action_random(seed):
    """Labels-v2-style games: every class (the three card classes too), both
    visibilities, predictions near most labels, on and off the frame grid
    (the two algorithms' frame mappings differ there), and false positives."""
    rng = np.random.default_rng(seed)
    labels = [c for c in action.DOMAIN.classes if c != "Card"] + action.card_classes
    games = []
    for g in range(2):
        anns, preds = [], []
        for half in (1, 2):
            for label in labels:
                for _ in range(int(rng.integers(1, 4))):
                    pos = int(rng.integers(1000, 45 * 60 * 1000))
                    anns.append(_ann(half, pos, label,
                                     "not shown" if rng.random() < 0.3 else "visible"))
                    out = "Yellow card" if label in action.card_classes else label
                    if rng.random() < 0.8:
                        preds.append(_pred(half, pos + int(rng.integers(-3000, 3000)), out,
                                           float(rng.random())))
                    if rng.random() < 0.3:
                        preds.append(_pred(half, int(rng.integers(1000, 45 * 60 * 1000)), out,
                                           float(rng.random())))
        games.append((f"league/action{g}", anns, preds))
    return "action", games


SCENARIOS = {
    "ball_perfect": _ball_perfect,
    "ball_absent_class": _ball_absent_class,
    "action_visibility": _action_visibility,
    "ball_random_0": lambda: _ball_random(0),
    "ball_random_1": lambda: _ball_random(1),
    "action_random_0": lambda: _action_random(0),
}


def _zip_tree(src: Path, out: Path, prefix_dot: bool) -> Path:
    with zipfile.ZipFile(out, "w") as zf:
        for p in sorted(src.rglob("*")):
            if p.is_file():
                rel = p.relative_to(src).as_posix()
                zf.write(p, arcname=f"./{rel}" if prefix_dot else rel)
    return out


def write_scenario(tmp_path, name, storage):
    """(domain name, games, labels root, predictions root): directories, or
    zips of them (the predictions' members with a leading ``./``, as the
    reference README's zip command stores them)."""
    domain_name, games = SCENARIOS[name]()
    domain = DOMAINS[domain_name][0]
    labels_root, preds_root = tmp_path / "labels", tmp_path / "preds"
    for game, anns, preds in games:
        (labels_root / game).mkdir(parents=True)
        (labels_root / game / domain.label_file).write_text(json.dumps({"annotations": anns}))
        (preds_root / game).mkdir(parents=True)
        (preds_root / game / "results_spotting.json").write_text(
            json.dumps({"predictions": preds}))
    if storage == "zip":
        labels_root = _zip_tree(labels_root, tmp_path / "labels.zip", prefix_dot=False)
        preds_root = _zip_tree(preds_root, tmp_path / "preds.zip", prefix_dot=True)
    return domain_name, [g for g, _, _ in games], labels_root, preds_root


@pytest.mark.parametrize("storage", ["dir", "zip"])
@pytest.mark.parametrize("algorithm", ["official", "matcher"])
@pytest.mark.parametrize("metric", ["at1", "tight"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_evaluate_games_equals_jax(tmp_path, scenario, metric, algorithm, storage):
    domain_name, games, labels_root, preds_root = write_scenario(tmp_path, scenario, storage)
    port_domain, jax_domain = DOMAINS[domain_name]
    got = soccernet_map.evaluate_games(labels_root, preds_root, games, port_domain,
                                       metric=metric, algorithm=algorithm)
    want = jax_map.evaluate_games(labels_root, preds_root, games, jax_domain,
                                  metric=metric, algorithm=algorithm)
    assert_same(got, want)
    assert 0.0 <= got["a_mAP"] <= 1.0
    assert (got["a_mAP_visible"] is None) == (domain_name == "ball")


def test_read_game_json_equals_jax(tmp_path):
    _, games, labels_zip, preds_zip = write_scenario(tmp_path, "ball_perfect", "zip")
    for root, rel in ((labels_zip, f"{games[0]}/Labels-ball.json"),
                      (preds_zip, f"{games[0]}/results_spotting.json")):
        assert soccernet_map.read_game_json(root, rel) == jax_map.read_game_json(root, rel)
    for module in (soccernet_map, jax_map):
        with pytest.raises(FileNotFoundError):
            module.read_game_json(labels_zip, "nope/Labels-ball.json")


# ----------------------------------------------------------- submission ---

def _spotting_tree(root: Path, games) -> None:
    for i, game in enumerate(games):
        spotting.write_game_spotting_results(
            {1: {"PASS": ([250 + i], [0.9])}, 2: {"DRIVE": ([251], [0.8])}}, game, root,
            ball.DOMAIN)


def _zip_members(path: Path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


@pytest.mark.parametrize("mode", ["games", "glob"])
def test_make_submission_zip_equals_jax(tmp_path, mode):
    games = ["league/season/g1", "league/season/g2"]
    pred_dir = tmp_path / "preds"
    _spotting_tree(pred_dir, games)
    kwargs = {"games": games} if mode == "games" else {}
    got = submission.make_submission_zip(pred_dir, out_path=tmp_path / "port.zip", **kwargs)
    want = jax_submission.make_submission_zip(pred_dir, out_path=tmp_path / "jax.zip", **kwargs)
    assert _zip_members(got) == _zip_members(want)
    assert list(_zip_members(got)) == [f"{g}/results_spotting.json" for g in games]
    default = submission.make_submission_zip(pred_dir, **kwargs)
    assert default == pred_dir / "results_spotting.zip"


def test_make_submission_zip_fails_loudly_like_jax(tmp_path):
    pred_dir = tmp_path / "preds"
    _spotting_tree(pred_dir, ["league/season/g1"])
    for module in (submission, jax_submission):
        with pytest.raises(FileNotFoundError, match="missing"):
            module.make_submission_zip(pred_dir, games=["league/season/g1", "league/x"])
        with pytest.raises(FileNotFoundError):
            module.make_submission_zip(tmp_path / "empty")


def test_make_submission_cli_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path))
    ens_dir = ball.DOMAIN.predictions_dir / "exp1" / "challenge" / "ensemble"
    _spotting_tree(ens_dir, ball.challenge_games)
    ball_make_submission.main(["--experiments", "exp1", "--out", str(tmp_path / "port.zip")])
    script = _load_script("scripts/ball_action/make_submission.py")
    monkeypatch.setattr(sys, "argv", ["make_submission.py", "--experiments", "exp1",
                                      "--out", str(tmp_path / "jax.zip")])
    script.main()
    assert _zip_members(tmp_path / "port.zip") == _zip_members(tmp_path / "jax.zip")
    (ens_dir / ball.challenge_games[1] / "results_spotting.json").unlink()
    with pytest.raises(FileNotFoundError, match="missing"):
        ball_make_submission.main(["--experiments", "exp1"])


# ------------------------------------------------- spotting and ensemble ---

def test_read_game_spotting_results_equals_jax(tmp_path):
    path = spotting.write_game_spotting_results(
        {1: {"Card": ([250], [0.5])}, 2: {"Goal": ([30], [0.25])}}, "league/g", tmp_path,
        action.DOMAIN)
    got = spotting.read_game_spotting_results(path)
    assert got == jax_spotting.read_game_spotting_results(path)
    assert [p["label"] for p in got["predictions"]] == ["Yellow card", "Goal"]


def _member(lo, n, seed, classes=2):
    rng = np.random.default_rng(seed)
    return np.arange(lo, lo + n), rng.random((n, classes)).astype(np.float32)


BLEND_CASES = {
    "same_window": [_member(7, 300, 0), _member(7, 300, 1)],
    "mixed_window": [_member(7, 300, 0), _member(16, 282, 1), _member(7, 300, 2)],
    "one_member": [_member(3, 50, 4, classes=15)],
    "disjoint": [_member(0, 10, 0), _member(20, 10, 1)],
    "misaligned": [_member(7, 300, 0), _member(8, 300, 1)],
}


@pytest.mark.parametrize("case", list(BLEND_CASES))
def test_blend_raw_predictions_equals_jax(case):
    loaded = BLEND_CASES[case]
    if case in ("disjoint", "misaligned"):
        match = "disjoint" if case == "disjoint" else "misaligned"
        for fn in (spotting.blend_raw_predictions, jax_spotting.blend_raw_predictions):
            with pytest.raises(ValueError, match=match):
                fn(loaded)
        return
    assert_same(spotting.blend_raw_predictions(loaded),
                jax_spotting.blend_raw_predictions(loaded))


def _load_script(rel: str):
    spec = importlib.util.spec_from_file_location(Path(rel).stem + "_script", ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree_files(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix == ".npz":
            with np.load(p) as npz:
                out[p.relative_to(root).as_posix()] = {k: npz[k] for k in npz.files}
        elif p.is_file():
            out[p.relative_to(root).as_posix()] = p.read_text()
    return out


@pytest.mark.parametrize("members", [2, 3])
def test_blend_and_write_equals_jax_ensemble(tmp_path, members):
    """``tests/test_ensemble.py``'s fixture: a shared strong peak, random
    background, both halves; with 3 members one covers a shorter window."""
    game, rng = "league/g", np.random.default_rng(0)
    paths = []
    for m in range(members):
        lo, n = (7, 300) if m < 2 else (16, 282)
        rp = (rng.random((n, 2)) * 0.3).astype(np.float32)
        rp[100 - lo:106 - lo, 0] = 1.0 - 0.2 * m
        for half in (1, 2):
            path = tmp_path / f"m{m}" / f"{half}_raw_predictions.npz"
            spotting.save_raw_predictions(path, np.arange(lo, lo + n), rp)
            paths.append(path)
    ball_ensemble.blend_and_write(paths, game, tmp_path / "port", ball.DOMAIN)
    _load_script("scripts/ball_action/ensemble.py").blend_and_write(
        paths, game, tmp_path / "jax", jax_ball.DOMAIN)
    got, want = _tree_files(tmp_path / "port"), _tree_files(tmp_path / "jax")
    assert_same(got, want)
    labels = {p["label"] for p in json.loads(got[f"{game}/results_spotting.json"])["predictions"]}
    assert "PASS" in labels


# ---------------------------------- one checkpoint, predict → evaluate ---

FRAMES = 90
EVENTS = {20: 0, 45: 1, 70: 0}


@pytest.fixture()
def fold_game(tmp_path, monkeypatch):
    """Fold 0's game as gray stores of synthetic frames with events, its
    ``Labels-ball.json`` at the events, and a JAX-written checkpoint."""
    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path))
    game = ball.fold2games[0][0]
    game_dir = ball.DOMAIN.soccernet_dir / game
    anns = []
    for half in (1, 2):
        src = JaxSyntheticSource(num_frames=FRAMES, height=64, width=96, seed=half,
                                 events=EVENTS)
        video = game_dir / f"{half}_720p.mkv"
        write_gray_store(str(video) + ".gray", (src.fetch_frame(i) for i in range(FRAMES)),
                         64, 96, FRAMES)
        Path(str(video) + ".info.json").write_text(json.dumps(
            dict(frame_count=FRAMES, fps=25.0, width=96, height=64)))
        anns += [_ann(half, frame * 40, ball.classes[cls]) for frame, cls in EVENTS.items()]
    (game_dir / "Labels-ball.json").write_text(json.dumps({"annotations": anns}))
    return game, make_ckpt(tmp_path / "model-001-0.900000.ckpt")


def test_one_checkpoint_predicts_and_scores_alike(fold_game, monkeypatch):
    game, ckpt = fold_game
    preds = ball.DOMAIN.predictions_dir
    jax_pipeline.predict_game(JaxChunkedVideoPredictor(ckpt, dtype=jnp.float32, chunk_size=16),
                              game, jax_ball.DOMAIN, preds / "jax_exp" / "cv" / "fold_0")
    predict_games(ckpt, [game], ball.DOMAIN, preds / "port_exp" / "cv" / "fold_0",
                  device="cpu", dtype=torch.float32, chunk_size=16)
    for half in (1, 2):
        rel = Path("cv/fold_0") / game / f"{half}_raw_predictions.npz"
        with np.load(preds / "jax_exp" / rel) as a, np.load(preds / "port_exp" / rel) as b:
            np.testing.assert_array_equal(a["frame_indexes"], b["frame_indexes"])
            np.testing.assert_allclose(b["raw_predictions"], a["raw_predictions"], atol=1e-4)

    jax_evaluate = _load_script("scripts/ball_action/evaluate.py")
    for algorithm in ("official", "matcher"):
        ball_evaluate.main(["--experiment", "port_exp", "--folds", "0",
                            "--algorithm", algorithm])
        got = json.loads((preds / "port_exp/cv/fold_0/evaluate_results.json").read_text())
        want = jax_evaluate.evaluate_fold("jax_exp", 0, algorithm)
        assert abs(got["a_mAP"] - want["a_mAP"]) <= 1e-6
        np.testing.assert_allclose(got["a_mAP_per_class"], want["a_mAP_per_class"], atol=1e-6)
        assert got["games"] == [game] and got["metric"] == "at1"
        assert 0.0 <= got["a_mAP"] <= 1.0
