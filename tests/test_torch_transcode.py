"""The port's transcode (``data/gray_store.py::transcode_video_to_store``
and ``cli/transcode.py``) against the JAX package's, after
``tests/test_opencv_transcode.py``: a video written with ``cv2`` decodes
into a store byte-identical to JAX's, and the CLI skips existing stores,
rewrites them with ``--force``, transcodes in parallel with ``--jobs 2``,
walks a domain's games and writes the same ``.info.json`` sidecar as
``scripts/transcode.py``."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from ball_action_spotting_tpu.data.gray_store import (  # noqa: E402
    transcode_video_to_store as jax_transcode,
)
from ball_action_spotting_torch.cli import transcode  # noqa: E402
from ball_action_spotting_torch.data.gray_store import (  # noqa: E402
    GrayStore,
    store_path_for_video,
    transcode_video_to_store,
)
from ball_action_spotting_torch.domains import ball  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
H, W, N = 64, 96, 30


def write_video(path: Path, seed: int = 0) -> np.ndarray:
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (W, H))
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(N):
        gray = np.full((H, W), (i * 8) % 256, dtype=np.uint8)
        gray[:, : W // 4] = rng.integers(0, 255)
        frames.append(gray)
        writer.write(cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
    writer.release()
    return np.stack(frames)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "half.avi"
    return path, write_video(path)


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_transcode_script",
                                                  ROOT / "scripts" / "transcode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_transcode_is_byte_identical_to_jax(video, tmp_path):
    path, frames = video
    info = transcode_video_to_store(path, tmp_path / "port.gray")
    jax_info = jax_transcode(path, tmp_path / "jax.gray")
    assert info == jax_info
    assert info["frame_count"] == N and info["fps"] == pytest.approx(25.0)
    assert (tmp_path / "port.gray").read_bytes() == (tmp_path / "jax.gray").read_bytes()
    decoded = GrayStore(tmp_path / "port.gray").read(0, N)
    assert np.abs(decoded.astype(int) - frames.astype(int)).mean() < 4  # MJPG is lossy


def test_transcode_one_skips_forces_and_writes_jax_sidecar(video, tmp_path):
    src, _ = video
    ours, theirs = tmp_path / "ours.avi", tmp_path / "theirs.avi"
    shutil.copy(src, ours)
    shutil.copy(src, theirs)
    transcode.transcode_one(ours)
    jax_script().transcode_one(theirs)
    store = store_path_for_video(ours)
    assert store.read_bytes() == store_path_for_video(theirs).read_bytes()
    sidecar = json.loads(Path(str(ours) + ".info.json").read_text())
    assert sidecar == json.loads(Path(str(theirs) + ".info.json").read_text())
    assert sidecar["frame_count"] == N

    store.write_bytes(b"stale")
    assert transcode.transcode_one(ours).startswith("skip (exists)")
    assert store.read_bytes() == b"stale"
    transcode.transcode_one(ours, force=True)
    assert store.read_bytes() == store_path_for_video(theirs).read_bytes()


def test_cli_jobs_and_domain(video, tmp_path, monkeypatch, capsys):
    src, _ = video
    paths = [tmp_path / f"half{i}.avi" for i in range(2)]
    for p in paths:
        shutil.copy(src, p)
    transcode.main(["--videos", *map(str, paths), "--jobs", "2"])
    for p in paths:
        assert GrayStore(store_path_for_video(p)).frame_count == N
        assert json.loads(Path(str(p) + ".info.json").read_text())["frame_count"] == N

    monkeypatch.setenv("BAS_TPU_WORKDIR", str(tmp_path / "work"))
    game = ball.fold_games[0]
    game_dir = ball.DOMAIN.soccernet_dir / game
    game_dir.mkdir(parents=True)
    for half in (1, 2):
        shutil.copy(src, game_dir / f"{half}_720p.mkv")
    shutil.copy(src, game_dir / "1_224p.mkv")
    transcode.main(["--domain", "ball_action", "--games", game])
    assert sorted(p.name for p in game_dir.glob("*.gray")) == ["1_720p.mkv.gray",
                                                               "2_720p.mkv.gray"]
    capsys.readouterr()
    transcode.main(["--domain", "ball_action"])  # every game of the domain, all exist
    assert capsys.readouterr().out.count("skip (exists)") == 2
    with pytest.raises(SystemExit, match="Nothing to transcode"):
        transcode.main([])


def test_cli_without_cv2_names_the_package(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        transcode.main(["--videos", str(tmp_path / "a.mkv")])
