"""The port's action domain against the JAX package on the CPU: the
``DOMAIN`` descriptor and split lists, ``load_games_list`` (from
``BAS_TPU_ACTION_SPLITS``, and its raise without the SoccerNet package),
Labels-v2 parsing with the three card classes merged into "Card" and the
visibility filter, the port's copy of ``action_sampling_weights_002``, and
the gray store's write side, read back by both packages. All of it is host
code on both sides, so everything must be equal."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from ball_action_spotting_tpu.core import annotations as jax_annotations
from ball_action_spotting_tpu.data.gray_store import GrayStore as JaxGrayStore
from ball_action_spotting_tpu.data.gray_store import GrayStoreSource as JaxGrayStoreSource
from ball_action_spotting_tpu.data.gray_store import write_gray_store as jax_write_gray_store
from ball_action_spotting_tpu.domains import action as jax_action
from ball_action_spotting_tpu.utils.experiments import load_experiment_config as jax_load_config
from ball_action_spotting_torch.core import annotations
from ball_action_spotting_torch.data.gray_store import GrayStoreSource, write_gray_store
from ball_action_spotting_torch.data.video import open_source
from ball_action_spotting_torch.domains import action
from ball_action_spotting_torch.utils.experiments import load_experiment_config

ROOT = Path(__file__).resolve().parents[1]


def test_action_domain_equals_jax():
    assert dataclasses.asdict(action.DOMAIN) == dataclasses.asdict(jax_action.DOMAIN)
    assert action.DOMAIN.num_classes == 15 and action.DOMAIN.label_file == "Labels-v2.json"
    assert action.DOMAIN.postprocess.as_dict() == {"gauss_sigma": 3.0, "height": 0.2,
                                                   "distance": 15}
    assert action.DOMAIN.merged_classes == {c: "Card" for c in action.card_classes}
    assert action.DOMAIN.output_class_map == {"Card": "Yellow card"}
    assert action.DOMAIN.visibility_filter == "visible"
    for name in ("val_games", "train_ignore_games", "card_classes", "classes"):
        assert getattr(action, name) == getattr(jax_action, name), name
    assert (action.num_classes, action.class2target, action.target2class) == \
        (jax_action.num_classes, jax_action.class2target, jax_action.target2class)


@pytest.mark.parametrize("split", ["train", "val", "test", "challenge"])
def test_load_games_list_from_env_equals_jax(tmp_path, monkeypatch, split):
    games = [f"league/{split}_{i}" for i in range(3)]
    (tmp_path / f"{split}.json").write_text(json.dumps(games))
    monkeypatch.setenv("BAS_TPU_ACTION_SPLITS", str(tmp_path))
    assert action.load_games_list(split) == jax_action.load_games_list(split) == games


@pytest.mark.parametrize("env", ["unset", "no_file"])
def test_load_games_list_without_soccernet_raises_like_jax(tmp_path, monkeypatch, env):
    try:
        import SoccerNet  # noqa: F401

        pytest.skip("SoccerNet installed; the fallback path is not reachable")
    except ImportError:
        pass
    if env == "unset":
        monkeypatch.delenv("BAS_TPU_ACTION_SPLITS", raising=False)
    else:
        monkeypatch.setenv("BAS_TPU_ACTION_SPLITS", str(tmp_path))  # holds no test.json
    for module in (action, jax_action):
        with pytest.raises(RuntimeError, match="SoccerNet"):
            module.load_games_list("test")


LABELS_V2 = {"annotations": [
    {"gameTime": "1 - 00:02", "label": "Goal", "position": "2000", "visibility": "visible"},
    {"gameTime": "1 - 00:04", "label": "Yellow card", "position": "4010",
     "visibility": "visible"},
    {"gameTime": "1 - 00:05", "label": "Red card", "position": "5020", "visibility": "visible"},
    {"gameTime": "1 - 00:06", "label": "Yellow->red card", "position": "6000",
     "visibility": "not shown"},
    {"gameTime": "1 - 00:07", "label": "Corner", "position": "7000", "visibility": "not shown"},
    {"gameTime": "2 - 00:01", "label": "Yellow->red card", "position": "1019",
     "visibility": "visible"},
    {"gameTime": "2 - 00:03", "label": "Throw-in", "position": "3000", "visibility": "visible"},
    {"gameTime": "2 - 00:03", "label": "Kick-off", "position": "3001", "visibility": "visible"},
    {"gameTime": "2 - 00:09", "label": "Red card", "position": "9000",
     "visibility": "not shown"},
    {"gameTime": "3 - 00:01", "label": "Goal", "position": "1000", "visibility": "visible"},
]}


def test_labels_v2_parsing_equals_jax(tmp_path):
    """Card merging, the visibility filter, position rounding and the EMPTY
    midpoints, through ``parse_game_annotations`` and the game loader."""
    fps = {1: 25.0, 2: 30.0}
    got = annotations.parse_game_annotations(LABELS_V2, action.DOMAIN, fps)
    assert got == jax_annotations.parse_game_annotations(LABELS_V2, jax_action.DOMAIN, fps)
    assert got == {1: {50: "Goal", 100: "Card", 126: "Card"}, 2: {31: "Card", 90: "Kick-off"}}

    game = "league/action_game"
    (tmp_path / game).mkdir(parents=True)
    (tmp_path / game / "Labels-v2.json").write_text(json.dumps(LABELS_V2))

    def info(path):
        return dict(frame_count=500, fps=25.0, width=96, height=64)

    for empty in (False, True):
        port = annotations.get_game_videos_data(game, action.DOMAIN, empty_actions=empty,
                                                video_info_fn=info, soccernet_dir=tmp_path)
        ref = jax_annotations.get_game_videos_data(game, jax_action.DOMAIN, empty_actions=empty,
                                                   video_info_fn=info, soccernet_dir=tmp_path)
        assert port == ref
        assert [v["half"] for v in port] == [1, 2, 3]


def test_port_action_config_equals_jax():
    name = "action_sampling_weights_002"
    port = load_experiment_config(name, action.DOMAIN)
    ref = jax_load_config(name, jax_action.DOMAIN, configs_dir=ROOT / "configs" / "action")
    assert port == ref
    nn_kwargs = port["argus_params"]["nn_module"][1]
    assert nn_kwargs["num_classes"] == 15 and port["ema_decay"] == 0.9995
    assert set(port["train_sampling_weights"]["action_weights"]) == set(action.classes)


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("shape", [(7, 16, 24), (3, 720, 1280)])
def test_write_gray_store_read_back_by_both_packages(tmp_path, shape):
    n, h, w = shape
    frames = _frames(n, h, w, seed=n)
    port_path, jax_path = tmp_path / "port.gray", tmp_path / "jax.gray"
    write_gray_store(port_path, iter(frames), h, w, n)
    jax_write_gray_store(jax_path, iter(frames), h, w, n)
    assert port_path.read_bytes() == jax_path.read_bytes()

    port_source, jax_store = GrayStoreSource(port_path), JaxGrayStore(port_path)
    assert (port_source.num_frames, port_source.height, port_source.width) == (n, h, w)
    assert (jax_store.frame_count, jax_store.height, jax_store.width) == (n, h, w)
    np.testing.assert_array_equal(jax_store.read(0, n), np.stack(frames))
    jax_source = JaxGrayStoreSource(port_path)
    indexes = [0, n - 1, 1, n + 4]  # the last one clamps
    np.testing.assert_array_equal(port_source.fetch_frames(indexes),
                                  jax_source.fetch_frames(indexes))
    for i in range(n):
        np.testing.assert_array_equal(port_source.fetch_frame(), frames[i])
    jax_store.close()


def test_write_gray_store_opens_as_the_video_source(tmp_path):
    video = tmp_path / "1_720p.mkv"
    frames = _frames(5, 8, 12, seed=0)
    write_gray_store(Path(str(video) + ".gray"), frames, 8, 12, 5)
    source = open_source({"video_path": str(video), "frame_index2action": {}})
    assert isinstance(source, GrayStoreSource)
    np.testing.assert_array_equal(source.fetch_frames([4, 2]), np.stack([frames[4], frames[2]]))


def test_write_gray_store_refuses_wrong_frames(tmp_path):
    with pytest.raises(ValueError, match="shape"):
        write_gray_store(tmp_path / "a.gray", [np.zeros((4, 5), np.uint8)], 4, 6, 1)
    with pytest.raises(ValueError, match="header"):
        write_gray_store(tmp_path / "b.gray", [np.zeros((4, 6), np.uint8)], 4, 6, 2)
