"""The port's ``SequentialWindowSource`` and ``make_sequential_factory``
against the JAX package's, mirroring ``tests/test_sequential_source.py``:
the same frames, the same decode and seek counts on the same windows
(eviction order and zero-fill included), pass-through for stores and
synthetic sources, and the port's validation dataset built through the
factory with a buffer of frame_stack_size · frame_stack_step · 2."""

import numpy as np
import pytest

from ball_action_spotting_tpu.data.video import SequentialWindowSource as JaxSequential
from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSynthetic
from ball_action_spotting_torch.data.gray_store import GrayStoreSource, write_gray_store
from ball_action_spotting_torch.data.video import (
    OpenCVSource,
    SequentialWindowSource,
    SyntheticSource,
    make_sequential_factory,
    open_source,
)
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.train.pipeline import build_datasets
from ball_action_spotting_torch.utils.recipe import spotting_recipe


def counting(base):
    class Counting(base):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.decodes = 0
            self.seeks = 0
            self.fail_at = set()

        def _frame(self, index):
            self.decodes += 1
            if index in self.fail_at:
                raise RuntimeError(f"decode failed at {index}")
            return super()._frame(index)

        def _seek_and_read(self, index):
            self.seeks += 1
            return super()._seek_and_read(index)

    return Counting


PortCounting, JaxCounting = counting(SyntheticSource), counting(JaxSynthetic)


def _windows(centers, size=5, step=2):
    return [[c + (i - size // 2) * step for i in range(size)] for c in centers]


# each case: buffer size, the windows fetched in order, frames whose decode fails
CASES = {
    "ordered_overlapping": (32, _windows(range(20, 200, 4)), ()),
    "small_backward_step": (32, _windows([30, 34, 40, 38, 120]), ()),
    "backward_reset": (16, [list(range(100, 110)), list(range(20, 30))], ()),
    "window_grows_the_buffer": (4, [list(range(10, 40)), list(range(35, 45))], ()),
    "present_frames_kept_while_gaps_decode": (8, [[10, 11], [0, 1, 2, 3],
                                                  list(range(10, 18))], ()),
    "eviction_order": (6, [[0, 1, 2], [3, 4, 5], [1, 6, 7], [0, 8]], ()),
    "decode_error_zero_fills": (16, [[50, 52, 54, 56], [54, 56, 58, 60]], (53,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_and_counts_equal_jax(case):
    buffer, windows, fail = CASES[case]
    inner, jax_inner = PortCounting(num_frames=300, seed=3), JaxCounting(num_frames=300, seed=3)
    inner.fail_at = jax_inner.fail_at = set(fail)
    ours, theirs = SequentialWindowSource(inner, buffer), JaxSequential(jax_inner, buffer)
    for w in windows:
        np.testing.assert_array_equal(ours.fetch_frames(w), theirs.fetch_frames(w))
        assert list(ours._buffer) == list(theirs._buffer)  # the same eviction order
    assert (inner.decodes, inner.seeks) == (jax_inner.decodes, jax_inner.seeks)
    assert ours.buffer_size == theirs.buffer_size


def test_ordered_windows_decode_each_frame_once():
    inner = PortCounting(num_frames=400)
    src = SequentialWindowSource(inner, buffer_size=32)
    windows = _windows(range(20, 200, 4))
    for w in windows:
        assert src.fetch_frames(w).shape == (5, inner.height, inner.width)
    assert inner.decodes == max(windows[-1]) - min(windows[0]) + 1
    assert inner.seeks == 1


def test_decode_error_leaves_zero_frames_and_recovers():
    inner = PortCounting(num_frames=100)
    inner.fail_at = {21}
    src = SequentialWindowSource(inner, buffer_size=16)
    out = src.fetch_frames([20, 21, 22])
    assert not out[1].any()  # the failed frame comes back as zeros
    np.testing.assert_array_equal(out[0], SyntheticSource(num_frames=100)._frame(20))


def test_fetch_frame_api_serves_from_buffer():
    inner = PortCounting(num_frames=100)
    src = SequentialWindowSource(inner, buffer_size=16)
    a, b = src.fetch_frame(10), src.fetch_frame()
    assert inner.decodes == 2
    np.testing.assert_array_equal(a, inner._frame(10))
    np.testing.assert_array_equal(b, inner._frame(11))


def test_factory_passes_stores_and_synthetic_sources_through(tmp_path):
    factory = make_sequential_factory(buffer_size=32)
    synthetic = {"video_path": "synthetic://0", "frame_count": 100, "height": 32, "width": 48,
                 "frame_index2action": {}, "classes": ["PASS"]}
    assert type(factory(synthetic)) is SyntheticSource
    video = tmp_path / "1_720p.mkv"
    write_gray_store(str(video) + ".gray", iter(np.zeros((3, 4, 5), np.uint8)), 4, 5, 3)
    assert type(factory({"video_path": str(video), "frame_index2action": {}})) is GrayStoreSource


def test_validation_dataset_wraps_a_codec_source(tmp_path):
    """``build_datasets`` gives the validation dataset the sequential
    factory with the JAX buffer (stack · step · 2), which wraps an
    ``OpenCVSource`` and reads the same frames as the bare decoder."""
    cv2 = pytest.importorskip("cv2")
    h, w, n = 32, 48, 60
    video = tmp_path / "1_720p.avi"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (w, h))
    for i in range(n):
        writer.write(cv2.cvtColor(np.full((h, w), (i * 4) % 256, np.uint8), cv2.COLOR_GRAY2BGR))
    writer.release()
    data = dict(video_path=str(video), game="g", half=1, frame_count=n, fps=25.0, width=w,
                height=h, frame_index2action={20: "PASS", 40: "DRIVE"})
    config = spotting_recipe(num_classes=2, image_size=(w, h), batch_size=2, train_epoch_size=4,
                             pretrained=False)
    _, val = build_datasets(config, ball.DOMAIN, [], [], videos_data=([data], [data]))
    ap = config["argus_params"]
    source = val.source_factory(data)
    assert isinstance(source, SequentialWindowSource)
    assert isinstance(source._source, OpenCVSource)
    assert source.buffer_size == ap["frame_stack_size"] * ap["frame_stack_step"] * 2 == 60
    _, indexes = val.get_video_frame_indexes(0)
    with open_source(data) as bare:
        np.testing.assert_array_equal(source.fetch_frames(indexes), bare.fetch_frames(indexes))
    source.close()
