"""The port's native gray-store reader (``csrc/gray_store.cpp`` behind
``data/gray_store.py``) against the JAX package's ``GrayStore`` and the
port's own numpy reader (``native=False``), byte for byte: reads, threaded
gathers with indexes clamped at both ends, gathers into padded views of a
batch buffer (which JAX's reader refuses), the loader over a 720-row store
padded to 736, corrupt stores, and builds that fail or run at once."""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ball_action_spotting_tpu.data.gray_store import GrayStore as JaxGrayStore
from ball_action_spotting_tpu.data.gray_store import GrayStoreSource as JaxGrayStoreSource
from ball_action_spotting_torch import native
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data import ClipLoader, ValClipDataset, open_source
from ball_action_spotting_torch.data import gray_store as port
from ball_action_spotting_torch.data.gray_store import (
    LIBRARY,
    GrayStore,
    GrayStoreSource,
    write_gray_store,
)

ROOT = Path(__file__).resolve().parents[1]
H, W, N = 16, 24, 50
# clips of a strided window, with indexes past both ends of the store
CLIPS = np.array([[0, 2, 4], [49, 51, -1], [10, 10, 12], [-5, 0, 100], [47, 48, 49]])


def _write(path, n, h, w, seed):
    frames = np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)
    write_gray_store(path, iter(frames), h, w, n)
    return frames


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp("store") / "video.gray"
    return path, _write(path, N, H, W, seed=0)


def test_native_library_builds():
    lib = LIBRARY.load()
    assert LIBRARY.library.exists() and LIBRARY.library.name.startswith("libgray_store-")
    assert lib.gray_store_gather is not None


@pytest.mark.parametrize("threads", [1, 3])
def test_gather_and_read_equal_jax_and_the_numpy_reader(store, threads):
    path, frames = store
    ours, plain = GrayStore(path, num_threads=threads), GrayStore(path, native=False)
    jax_store = JaxGrayStore(path, num_threads=threads)
    assert (ours.height, ours.width, ours.frame_count) == (H, W, N)
    assert (jax_store.height, jax_store.width, jax_store.frame_count) == (H, W, N)
    got = ours.gather(CLIPS)
    assert got.shape == (len(CLIPS), 3, H, W)
    assert got.tobytes() == jax_store.gather(CLIPS).tobytes() == plain.gather(CLIPS).tobytes()
    np.testing.assert_array_equal(got, frames[np.clip(CLIPS, 0, N - 1)])
    assert ours.read(10, 3).tobytes() == jax_store.read(10, 3).tobytes() \
        == plain.read(10, 3).tobytes() == frames[10:13].tobytes()
    with pytest.raises(IndexError):
        ours.read(N - 1, 2)
    for reader in (ours, plain, jax_store):
        reader.close()


@pytest.mark.parametrize("threads", [1, 4])
def test_gather_into_padded_views_equals_the_numpy_reader(tmp_path, threads):
    """720 stored rows into a slot of 736 (the flagship's pad) and a narrower
    width in a wider buffer: the rows are written in place, nothing around
    them is touched."""
    h, w, n = 720, 40, 12
    path = tmp_path / "v.gray"
    _write(path, n, h, w, seed=1)
    ours, plain = GrayStore(path, num_threads=threads), GrayStore(path, native=False)
    clips = np.array([[0, 3, 6, 9, 12], [-2, 1, 4, 7, 11]])
    buf = np.full((2, 5, 736, 48), 7, np.uint8)
    view = buf[:, :, 8:728, 4:44]
    assert not view.flags.c_contiguous
    ours.gather(clips, out=view)
    np.testing.assert_array_equal(view, plain.gather(clips))
    outside = buf.copy()
    outside[:, :, 8:728, 4:44] = 7
    assert (outside == 7).all()

    # one clip through the source, as the loader calls it
    slot = np.zeros((5, 736, w), np.uint8)
    GrayStoreSource(path, num_threads=threads).fetch_frames_into(clips[1], slot[:, 8:728, :])
    expected = np.zeros_like(slot)
    plain.gather(clips[1:2], out=expected[None, :, 8:728, :])
    assert slot.tobytes() == expected.tobytes() and not slot[:, :8].any()


def test_jax_reader_refuses_the_padded_view(tmp_path):
    """The divergence the port's strided gather repairs: JAX's reader asserts
    a C-contiguous output, so its source cannot fill the loader's padded slot."""
    path = tmp_path / "v.gray"
    _write(path, 8, 12, 16, seed=2)
    buf = np.zeros((5, 16, 16), np.uint8)
    with pytest.raises(AssertionError):
        JaxGrayStoreSource(path).fetch_frames_into([0, 1, 2, 3, 4], buf[:, 2:14, :])
    GrayStoreSource(path).fetch_frames_into([0, 1, 2, 3, 4], buf[:, 2:14, :])
    np.testing.assert_array_equal(buf[:, 2:14], GrayStore(path, native=False).read(0, 5))


def test_gather_refuses_a_wrong_output(store):
    path, _ = store
    ours = GrayStore(path)
    with pytest.raises(ValueError, match="shape"):
        ours.gather(CLIPS, out=np.empty((len(CLIPS), 3, H, W + 1), np.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        ours.gather(CLIPS, out=np.empty((len(CLIPS), 3, W, H), np.uint8).transpose(0, 1, 3, 2))
    frozen = np.empty((len(CLIPS), 3, H, W), np.uint8)
    frozen.flags.writeable = False
    with pytest.raises(ValueError, match="read-only"):
        ours.gather(CLIPS, out=frozen)


def test_loader_over_a_720_row_store_at_736_rows(tmp_path, monkeypatch):
    """The port's ClipLoader pads a 720-row store into 736-row batches
    through the native gather, equal to the same loader whose sources read
    through the numpy reader."""
    h, w, n = 720, 32, 80
    video = tmp_path / "1_720p.mkv"
    _write(Path(str(video) + ".gray"), n, h, w, seed=3)
    video_data = [dict(video_path=str(video), game="g", half=1, frame_count=n, fps=25.0,
                       width=w, height=h,
                       frame_index2action={10: "PASS", 25: "DRIVE", 40: "PASS", 70: "DRIVE"})]

    def batches(factory):
        ds = ValClipDataset(video_data, ["PASS", "DRIVE"], StackIndexesGenerator(5, 2),
                            MaxWindowTargetsProcessor(3), image_size=(w, 736),
                            source_factory=factory)
        return [(f.copy(), t.copy()) for f, t in
                ClipLoader(ds, 3, num_workers=2, ordered=True).epoch(0)]

    ours = batches(open_source)
    monkeypatch.setattr(port, "GrayStore", functools.partial(GrayStore, native=False))
    plain = batches(open_source)
    assert len(ours) == len(plain) == 2
    for (f1, t1), (f2, t2) in zip(ours, plain):
        assert f1.shape[2:] == (736, w)
        assert f1.tobytes() == f2.tobytes()
        np.testing.assert_array_equal(t1, t2)
        assert not f1[:, :, :8].any() and not f1[:, :, 728:].any()


def test_corrupt_or_truncated_store_is_refused(tmp_path):
    bad = tmp_path / "bad.gray"
    bad.write_bytes(b"NOTASTORE" + b"\0" * 100)
    for native_reader in (True, False):
        with pytest.raises(OSError):
            GrayStore(bad, native=native_reader)
    short = tmp_path / "short.gray"
    _write(short, 4, 8, 8, seed=4)
    short.write_bytes(short.read_bytes()[:-1])
    with pytest.raises(OSError, match="rc=-5"):
        GrayStore(short)
    (tmp_path / "tiny.gray").write_bytes(b"GRAY")
    with pytest.raises(OSError):
        GrayStore(tmp_path / "tiny.gray")


def test_failed_build_raises_and_nothing_falls_back(store, tmp_path, monkeypatch):
    """A compiler that cannot run, or that fails, raises with what it said;
    the store, its source and ``open_source`` then raise too. Only
    ``native=False`` reads through numpy."""
    path, frames = store
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    missing = str(tmp_path / "no" / "g++")
    monkeypatch.setattr(native.HostLibrary, "compile_command",
                        lambda self, output: [missing, "-o", str(output), str(self.source)])
    monkeypatch.setattr(port, "LIBRARY", native.HostLibrary("gray_store"))
    with pytest.raises(RuntimeError, match="cannot run .*g\\+\\+"):
        GrayStore(path)
    with pytest.raises(RuntimeError):
        GrayStoreSource(path)
    video = path.with_suffix("")  # <video>.gray is the store of <video>
    with pytest.raises(RuntimeError):
        open_source({"video_path": str(video), "frame_index2action": {}})
    monkeypatch.setattr(native.HostLibrary, "compile_command",
                        lambda self, output: ["false", "-o", str(output), str(self.source)])
    monkeypatch.setattr(port, "LIBRARY", native.HostLibrary("gray_store"))
    with pytest.raises(RuntimeError, match="failed to build"):
        GrayStore(path)
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary file left
    np.testing.assert_array_equal(GrayStore(path, native=False).read(0, 2), frames[:2])


_BUILD = """
import sys
from pathlib import Path
from ball_action_spotting_torch import native
native.BUILD_DIR = Path(sys.argv[1])
from ball_action_spotting_torch.data.gray_store import LIBRARY, GrayStore
LIBRARY.load()
store = GrayStore(sys.argv[2], num_threads=2)
print(store.gather([[0, 1, 60]]).sum())
"""


def test_concurrent_builds_leave_one_good_library(store, tmp_path):
    """Several processes building the same source at once (the test workers)
    each compile to a name of their own and rename it into place."""
    path, frames = store
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build), str(path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    expected = int(frames[[0, 1, N - 1]].sum(dtype=np.int64))
    assert [int(out.strip()) for out, _ in outs] == [expected] * 3
    built = sorted(p.name for p in build.iterdir())
    assert len(built) == 1 and built[0].startswith("libgray_store-") and built[0].endswith(".so")
