"""Port data path against the JAX package: sampling weights (with
out-of-fold hard negatives), the label parser, the training and validation
datasets for the same seed, epoch and index (the port keeps JAX's numpy
RNG, so it must draw the same clips), the ordered loader, the gray store's
window fetch, and the prefetch's copy out of the loader's pooled buffers.
Everything here is exact: integer frames, numpy float64 weights."""

import json

import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.core import annotations as jann
from ball_action_spotting_tpu.core.indexes import FrameIndexShaker as JaxShaker
from ball_action_spotting_tpu.core.indexes import StackIndexesGenerator as JaxGen
from ball_action_spotting_tpu.core.sampling import ball_sampling_weights as jax_weights
from ball_action_spotting_tpu.core.targets import MaxWindowTargetsProcessor as JaxTargets
from ball_action_spotting_tpu.data import ClipLoader as JaxLoader
from ball_action_spotting_tpu.data import TrainClipDataset as JaxTrain
from ball_action_spotting_tpu.data import ValClipDataset as JaxVal
from ball_action_spotting_tpu.data import make_synthetic_video_data as jax_videos
from ball_action_spotting_tpu.data.gray_store import GrayStoreSource as JaxGray
from ball_action_spotting_tpu.data.gray_store import write_gray_store
from ball_action_spotting_tpu.domains import ball as jax_ball
from ball_action_spotting_torch.core import annotations as ann
from ball_action_spotting_torch.core.indexes import FrameIndexShaker, StackIndexesGenerator
from ball_action_spotting_torch.core.sampling import ball_sampling_weights
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data import (
    ClipLoader,
    TrainClipDataset,
    ValClipDataset,
    make_synthetic_video_data,
    prefetch_to_device,
)
from ball_action_spotting_torch.data.gray_store import GrayStoreSource
from ball_action_spotting_torch.domains import ball

CLASSES = ["PASS", "DRIVE"]
SHAKER = {"shifts": [-1, 0, 1], "weights": [0.2, 0.6, 0.2], "prob": 0.5}


def test_synthetic_video_data_matches_jax():
    assert make_synthetic_video_data(3, 300, CLASSES, 30, 40, 56) == jax_videos(
        3, 300, CLASSES, 30, 40, 56)


@pytest.mark.parametrize("oof", [False, True])
def test_ball_sampling_weights_match_jax(oof):
    video = make_synthetic_video_data(1, 400, CLASSES)[0]
    kwargs = {}
    if oof:
        rng = np.random.default_rng(0)
        kwargs = dict(oof_frame_indexes=np.arange(20, 380),
                      oof_predictions=rng.random((360, 2)).astype(np.float32))
    port = ball_sampling_weights(video, 9, 0.5, 27, **kwargs)
    np.testing.assert_array_equal(port, jax_weights(video, 9, 0.5, 27, **kwargs))
    assert abs(port.sum() - 1.0) < 1e-12


def test_get_videos_data_matches_jax(tmp_path):
    game = "league/2020/a - b"
    (tmp_path / game).mkdir(parents=True)
    labels = {"annotations": [
        {"gameTime": f"{half} - 00:{s:02d}", "label": label, "position": str(s * 1000 + 3),
         "visibility": "visible"}
        for half, s, label in ((1, 5, "PASS"), (1, 9, "DRIVE"), (2, 7, "PASS"), (1, 30, "PASS"))
    ]}
    (tmp_path / game / "Labels-ball.json").write_text(json.dumps(labels))

    def info(path):
        return {"frame_count": 1000, "fps": 25.0, "width": 96, "height": 64}

    for empty in (False, True):
        port = ann.get_videos_data([game], ball.DOMAIN, empty_actions=empty,
                                   video_info_fn=info, soccernet_dir=tmp_path)
        ref = jann.get_videos_data([game], jax_ball.DOMAIN, empty_actions=empty,
                                   video_info_fn=info, soccernet_dir=tmp_path)
        assert port == ref


def _datasets(videos, port: bool, epoch_size=12, seed=5):
    gen, tproc, shaker, train, val = (
        (StackIndexesGenerator, MaxWindowTargetsProcessor, FrameIndexShaker,
         TrainClipDataset, ValClipDataset) if port else
        (JaxGen, JaxTargets, JaxShaker, JaxTrain, JaxVal))
    weights = [ball_sampling_weights(v, 5, 0.5, 5) for v in videos]
    train_ds = train(videos, CLASSES, gen(6, 2), tproc(6), image_size=(104, 72),
                     epoch_size=epoch_size, videos_sampling_weights=weights,
                     frame_index_shaker=shaker(**SHAKER), base_seed=seed)
    val_ds = val(videos, CLASSES, gen(6, 2), tproc(6), image_size=(104, 72))
    return train_ds, val_ds


def test_datasets_draw_the_same_clips_as_jax():
    videos = make_synthetic_video_data(3, 300, CLASSES, height=64, width=96)
    (ptrain, pval), (jtrain, jval) = _datasets(videos, True), _datasets(videos, False)
    for epoch in (0, 3):
        for index in range(len(ptrain)):
            assert ptrain.get_video_frame_indexes(index, epoch) == \
                jtrain.get_video_frame_indexes(index, epoch)
    for index in (0, 7):
        for (pf, pt), (jf, jt) in ((ptrain.get(index, 2), jtrain.get(index, 2)),
                                   (pval.get(index), jval.get(index))):
            assert pf.shape == (6, 72, 104) and pf.dtype == np.uint8
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(pt, jt)
    assert len(pval) == len(jval)


def test_ordered_loader_batches_match_jax():
    videos = make_synthetic_video_data(2, 240, CLASSES, height=64, width=96)
    (ptrain, pval), (jtrain, jval) = _datasets(videos, True), _datasets(videos, False)
    for pds, jds in ((ptrain, jtrain), (pval, jval)):
        port = list(ClipLoader(pds, 5, num_workers=3, ordered=True, copy_out=True).epoch(1))
        ref = list(JaxLoader(jds, 5, num_workers=2, ordered=True, copy_out=True).epoch(1))
        assert len(port) == len(ref) == -(-len(pds) // 5)
        for (pf, pt), (jf, jt) in zip(port, ref):
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(pt, jt)


def test_prefetch_copies_out_of_the_pool_slot(monkeypatch):
    """With the pool poisoned at every reuse, batches that went through
    ``prefetch_to_device`` still hold their own pixels."""
    monkeypatch.setenv("BAS_TPU_LOADER_POISON", "1")
    videos = make_synthetic_video_data(2, 240, CLASSES, height=64, width=96)
    _, val = _datasets(videos, True)
    ref = list(ClipLoader(val, 2, num_workers=1, ordered=True, copy_out=True).epoch(0))
    loader = ClipLoader(val, 2, num_workers=1, ordered=True)
    got = list(prefetch_to_device(loader.epoch(0), "cpu", size=2))
    assert len(got) == len(ref) > 4  # more batches than pool slots
    for (frames, targets), (rf, rt) in zip(got, ref):
        assert frames.dtype == torch.uint8 and targets.dtype == torch.float32
        np.testing.assert_array_equal(frames.numpy(), rf)
        np.testing.assert_array_equal(targets.numpy(), rt)
        assert not (frames == 0xAB).all()


def test_gray_store_window_fetch_matches_jax(tmp_path):
    frames = np.random.default_rng(0).integers(0, 255, (20, 8, 12), dtype=np.uint8)
    path = tmp_path / "v.mkv.gray"
    write_gray_store(path, iter(frames), 8, 12, 20)
    indexes = [-2, 0, 3, 5, 19, 22]  # clamped at both ends
    port, ref = GrayStoreSource(path), JaxGray(path)
    out = np.zeros((len(indexes), 8, 12), np.uint8)
    port.fetch_frames_into(indexes, out)
    np.testing.assert_array_equal(out, ref.fetch_frames(indexes))
    np.testing.assert_array_equal(port.fetch_frames(indexes), out)
    port.close()
    ref.close()
