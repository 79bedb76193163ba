"""The port's multi-stream serving engines on the CPU, after
``tests/test_multistream.py``: batched across streams, the host-state and
the device-state engine must give what a dedicated ``StreamingPredictor``
gives each stream, the host-state engine also spread over a grid of 8 CPU
devices (``mesh=``); and one feed through the JAX package's two engines and
the port's.

Tolerances: against the port's per-stream engine atol 1e-6 in float32
(the same weights and math; only the batch composition differs, and the
device-state engine runs ``forward_2d_nhwc`` and ``forward_3d_head``, whose
sums run in another order); against the JAX engines 1e-5, as
``tests/test_torch_predict.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.predict.multistream import (
    DeviceStateMultiStreamPredictor as JaxDeviceStateMultiStreamPredictor,
    MultiStreamPredictor as JaxMultiStreamPredictor,
)
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.multistream import (
    DeviceStateMultiStreamPredictor,
    MultiStreamPredictor,
    _bucket,
    device_state_tick_ms,
    device_tick_ms,
)
from ball_action_spotting_torch.predict.streaming import StreamingPredictor, get_raw_predictions
from tests.test_torch_predict import FRAME_COUNT, make_ckpt

ATOL = 1e-6
JAX_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("ckpt") / "model-001-0.500000.ckpt")


def engine(cls, ckpt, tta=False, **kwargs):
    return cls(ckpt, tta=tta, dtype=torch.float32, device="cpu", **kwargs)


def source(seed, cls=SyntheticSource):
    return cls(num_frames=FRAME_COUNT, height=64, width=96, seed=seed, events={20: 0, 30: 1})


def frames_of(seed):
    src = source(seed)
    return [src.fetch_frame() for _ in range(FRAME_COUNT)]


@functools.lru_cache(maxsize=None)
def _per_stream(ckpt, seed, tta):
    return get_raw_predictions(engine(StreamingPredictor, ckpt, tta), source(seed), FRAME_COUNT)


def assert_per_stream(ckpt, seed, collected, tta=False, allow_missing=0):
    """``collected`` {predict index: prediction} holds the per-stream
    engine's predictions (all but ``allow_missing`` of them: a backlog of
    two frames per call can leave the last one unfed)."""
    idx, raw = _per_stream(ckpt, seed, tta)
    got_idx = [i for i in idx if i in collected]
    assert len(got_idx) >= len(idx) - allow_missing
    got = np.stack([collected[i] for i in got_idx])
    ref = np.stack([raw[idx.index(i)] for i in got_idx])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def ticks(multi):
    """The (bucket, frames per slot, masked) tick variants a device-state
    engine has run."""
    return {key[1:] for key in multi._shapes if key[0] == "tick"}


def collect(outputs, into):
    for s, pred, pi in outputs:
        if pred is not None and pi >= 0:
            into.setdefault(s, {})[pi] = pred.numpy()


def staggered_feed(multi, seeds, collected):
    """Stream s starts at tick 2s, one frame per tick."""
    frames = {s: frames_of(seed) for s, seed in seeds.items()}
    positions = {s: -1 for s in seeds}
    for tick in range(FRAME_COUNT + 2 * len(seeds)):
        batch = []
        for k, s in enumerate(seeds):
            if tick >= 2 * k and positions[s] + 1 < FRAME_COUNT:
                positions[s] += 1
                batch.append((s, frames[s][positions[s]], positions[s]))
        if not batch:
            break
        collect(multi.predict_batch(batch), collected)


def test_bucket():
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]


def test_bucket_shape_granularity_above_16():
    """Above 16 rows buckets step by ``bucket_granularity``; one step at 12
    between 8 and 16; granularity 0 keeps pure powers of two."""
    p = object.__new__(MultiStreamPredictor)
    p.bucket_granularity = 8
    assert [p._bucket_shape(n) for n in (16, 17, 24, 25, 33, 38, 41, 64)] \
        == [16, 24, 24, 32, 40, 40, 48, 64]
    assert [p._bucket_shape(n) for n in (1, 3, 7, 8, 9, 12, 13, 16)] \
        == [1, 4, 8, 8, 12, 12, 16, 16]
    p.bucket_granularity = 0
    assert [p._bucket_shape(n) for n in (9, 17, 33, 38)] == [16, 32, 64, 64]
    p.bucket_granularity = 4
    assert [p._bucket_shape(n) for n in (9, 13, 17, 21, 29)] == [12, 16, 20, 24, 32]


def test_multistream_mesh_matches_per_stream(ckpt_path):
    """``mesh=``: each call's batch split over an 8-device data axis of the
    CPU reproduces a per-stream ``StreamingPredictor`` within 1e-5; buckets
    are floored at the axis size, warmup runs every one serving reaches,
    and serving adds no shape."""
    multi = engine(MultiStreamPredictor, ckpt_path, mesh=make_mesh(8, 1, ["cpu"] * 8))
    assert multi._min_bucket == 8 and len(multi.shares) == 8
    assert multi.warmup(2) == [8]
    shapes = set(multi._shapes)
    assert shapes == {("split", 1), ("fwd3d_rows", 1), ("split", 8)}  # shares of 1 row
    collected = {}
    for i, frame in enumerate(frames_of(6)):
        collect(multi.predict_batch([("a", frame, i)]), collected)
    idx, raw = _per_stream(ckpt_path, 6, False)
    got = np.stack([collected["a"][i] for i in idx])
    np.testing.assert_allclose(got, raw, atol=JAX_ATOL, rtol=0)
    assert multi._shapes == shapes


def test_bucket_shape_divides_the_mesh_data_axis():
    """With a 6-device data axis n = 7 buckets to 12, not 8: every bucket
    splits into equal shares."""
    p = object.__new__(MultiStreamPredictor)
    p.bucket_granularity = 8
    p._min_bucket = 6
    assert p._bucket_shape(1) == 6
    assert p._bucket_shape(7) == 12
    assert p._bucket_shape(13) == 18
    p._min_bucket = 4  # 12 divides a 4-wide axis, so the sub-16 step stays
    assert [p._bucket_shape(n) for n in (1, 3, 7, 9)] == [4, 4, 8, 12]
    p._min_bucket = 1  # no mesh: unchanged
    assert [p._bucket_shape(n) for n in (1, 3, 7)] == [1, 4, 8]


def test_device_state_refuses_a_mesh(ckpt_path):
    with pytest.raises(ValueError, match="single-chip"):
        engine(DeviceStateMultiStreamPredictor, ckpt_path, mesh=make_mesh(2, 1, ["cpu"] * 2))


@pytest.mark.parametrize("cls", [MultiStreamPredictor, DeviceStateMultiStreamPredictor],
                         ids=["host_state", "device_state"])
def test_multistream_matches_per_stream(ckpt_path, cls):
    """Staggered admission of 3 streams (the device-state engine from a
    capacity of 2, so its rings grow once)."""
    kwargs = {"slot_capacity": 2} if cls is DeviceStateMultiStreamPredictor else {}
    multi = engine(cls, ckpt_path, **kwargs)
    seeds = {s: 10 + s for s in range(3)}
    collected = {}
    staggered_feed(multi, seeds, collected)
    for s, seed in seeds.items():
        assert_per_stream(ckpt_path, seed, collected[s])
    if cls is DeviceStateMultiStreamPredictor:
        assert multi._cap == 4 and multi._stream_at == [0, 1, 2]


def test_multistream_tta_and_stream_lifecycle(ckpt_path):
    multi = engine(MultiStreamPredictor, ckpt_path, tta=True)
    collected = {}
    for i, frame in enumerate(frames_of(4)):
        collect(multi.predict_batch([("a", frame, i)]), collected)
    assert_per_stream(ckpt_path, 4, collected["a"], tta=True)
    multi.close_stream("a")
    assert "a" not in multi._streams


def test_multistream_multiple_frames_per_stream_per_call(ckpt_path):
    """Four consecutive frames of one stream per call: a later frame's
    eviction horizon must not break an earlier frame's window."""
    multi = engine(MultiStreamPredictor, ckpt_path)
    frames = frames_of(10)
    collected = {}
    for c0 in range(0, FRAME_COUNT, 4):
        collect(multi.predict_batch([("s", frames[c0 + j], c0 + j)
                                     for j in range(min(4, FRAME_COUNT - c0))]), collected)
    assert_per_stream(ckpt_path, 10, collected["s"])


def test_warmup_runs_all_serving_buckets(ckpt_path):
    """After ``warmup(K, include_rampup=True)``, serving K streams with
    simultaneous admission (whose first window encodes num_stacks stacks
    per stream) runs no batch shape warmup did not run."""
    k = 5
    multi = engine(MultiStreamPredictor, ckpt_path)
    warmed = multi.warmup(k, include_rampup=True)
    assert warmed == [1, 2, 4, 8, 12]  # the ladder up to num_stacks·k = 10
    shapes = set(multi._shapes)
    assert shapes == {(name, b) for name in ("split", "fwd3d_rows") for b in warmed}
    frames = {s: frames_of(10 + s) for s in range(k)}
    got = 0
    for i in range(FRAME_COUNT):
        for _, pred, _ in multi.predict_batch([(s, frames[s][i], i) for s in range(k)]):
            got += pred is not None
    assert got > 0
    assert multi._shapes == shapes


def test_device_state_tta_and_uniform_backlog(ckpt_path):
    """TTA on and two frames per call: one (bucket, F=2) tick each."""
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path, tta=True)
    frames = frames_of(4)
    collected = {}
    for c0 in range(0, FRAME_COUNT - 1, 2):
        collect(multi.predict_batch([("a", frames[c0 + j], c0 + j) for j in range(2)]),
                collected)
    assert_per_stream(ckpt_path, 4, collected["a"], tta=True, allow_missing=2)
    assert {key[:2] for key in ticks(multi)} == {(1, 2)}


def test_device_state_ragged_backlog_and_lifecycle(ckpt_path):
    """Ragged backlogs (2 frames of one stream, 1 of another per call) run
    as F=1 layers; closing a stream compacts the slots; a gap raises."""
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path, slot_capacity=2)
    frames = {s: frames_of(10 + s) for s in (0, 1)}
    collected = {}
    p0 = p1 = 0
    while p0 < FRAME_COUNT - 1 or p1 < FRAME_COUNT:
        batch = []
        if p0 < FRAME_COUNT - 1:
            batch += [(0, frames[0][p0], p0), (0, frames[0][p0 + 1], p0 + 1)]
            p0 += 2
        if p1 < FRAME_COUNT:
            batch.append((1, frames[1][p1], p1))
            p1 += 1
        collect(multi.predict_batch(batch), collected)
    for s in (0, 1):
        assert_per_stream(ckpt_path, 10 + s, collected[s], allow_missing=2)

    assert multi._slot_of == {0: 0, 1: 1}
    multi.close_stream(0)
    assert 0 not in multi._slot_of
    assert multi._slot_of[1] == 0 and multi._stream_at == [1]
    multi.predict_batch([("new", frames[0][0], 0)])
    assert multi._slot_of["new"] == 1
    with pytest.raises(ValueError, match=r"consecutive \(got 5, expected 1\)"):
        multi.predict_batch([("new", frames[0][5], 5)])
    with pytest.raises(ValueError, match=r"consecutive \(got 3 after 1\)"):
        multi.predict_batch([("new", frames[0][1], 1), ("new", frames[0][3], 3)])


def test_device_state_close_swap_preserves_streams(ckpt_path):
    """Closing a stream mid-run moves the last slot's rows into the hole;
    the moved stream's later predictions stay right."""
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path, slot_capacity=4)
    frames = {s: frames_of(10 + s) for s in range(3)}
    collected = {}
    closed_at = FRAME_COUNT // 2
    for i in range(FRAME_COUNT):
        if i == closed_at:
            multi.close_stream(0)  # stream 2 moves into row 0
            assert multi._slot_of[2] == 0
        collect(multi.predict_batch([(s, frames[s][i], i) for s in range(3)
                                     if s != 0 or i < closed_at]), collected)
    for s in (1, 2):
        assert_per_stream(ckpt_path, 10 + s, collected[s])


def test_device_state_masked_tick_keeps_inactive_rows(ckpt_path):
    """The masked tick leaves the rows of streams that fed nothing to the
    byte, and advances the others."""
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path, slot_capacity=4)
    frames = {s: frames_of(10 + s) for s in range(3)}
    for i in range(8):
        multi.predict_batch([(s, frames[s][i], i) for s in range(3)])
    before = multi._frames_ring.clone(), multi._feats_ring.clone()
    multi.predict_batch([(1, frames[1][8], 8)])
    assert (4, 1, True) in ticks(multi)
    for ring, old in zip((multi._frames_ring, multi._feats_ring), before):
        assert torch.equal(ring[0], old[0]) and torch.equal(ring[2], old[2])
        assert not torch.equal(ring[1], old[1])


def test_device_tick_ms_smoke(ckpt_path):
    """Both tick timers run and return a positive latency per tick; the
    device-state one times the mask-free variant on copies of the rings."""
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path, slot_capacity=2)
    rings = multi._frames_ring.clone(), multi._feats_ring.clone()
    ms, times = device_state_tick_ms(multi, bucket=2, scan_lengths=(1, 3), reps=1)
    assert ms > 0 and np.isfinite(ms) and set(times) == {1, 3}
    assert (2, 1, False) in ticks(multi)
    assert torch.equal(multi._frames_ring, rings[0]) and torch.equal(multi._feats_ring, rings[1])
    ms, times = device_tick_ms(multi, bucket=2, scan_lengths=(1, 3), reps=1)
    assert ms > 0 and np.isfinite(ms) and set(times) == {1, 3}


def test_device_state_warmup_bounds_programs(ckpt_path):
    """After ``warmup(K)``, serving K streams needs no tick variant warmup
    did not run, both the masked and the mask-free one per bucket."""
    k = 3
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path)
    assert multi.warmup(k) == [1, 2, 4]
    tick_keys = ticks(multi)
    assert tick_keys == {(b, 1, masked) for b in (1, 2, 4) for masked in (True, False)}
    frames = {s: frames_of(10 + s) for s in range(k)}
    got = 0
    for i in range(FRAME_COUNT):
        for _, pred, _ in multi.predict_batch([(s, frames[s][i], i) for s in range(k)]):
            got += pred is not None
    assert got > 0
    assert ticks(multi) == tick_keys


def test_device_state_warmup_then_serve_matches(ckpt_path):
    """Warmup leaves the live rings as they were, padding slots advance
    while serving; neither reaches a prediction."""
    multi = engine(DeviceStateMultiStreamPredictor, ckpt_path, slot_capacity=4)
    multi.warmup(4, frames_per_tick=2)
    assert not multi._frames_ring.any() and not multi._feats_ring.any()
    seeds = {s: 10 + s for s in range(2)}
    frames = {s: frames_of(seed) for s, seed in seeds.items()}
    collected = {}
    for i in range(FRAME_COUNT):
        collect(multi.predict_batch([(s, frames[s][i], i) for s in seeds]), collected)
    for s, seed in seeds.items():
        assert_per_stream(ckpt_path, seed, collected[s])


def test_engines_match_jax(ckpt_path):
    """One feed (staggered admission, TTA on, then a backlog of two frames
    per stream) through the JAX package's two engines and the port's."""
    seeds = {"a": 10, "b": 11}
    frames = {s: frames_of(seed) for s, seed in seeds.items()}
    jax_frames = {s: [src.fetch_frame() for _ in range(FRAME_COUNT)]
                  for s, src in ((s, source(seed, JaxSyntheticSource)) for s, seed in seeds.items())}
    feed = [[("a", 0)], [("a", 1)]] + [[("a", i), ("b", i - 2)] for i in range(2, 20)] + \
        [[("a", i), ("a", i + 1), ("b", i - 2), ("b", i - 1)] for i in range(20, FRAME_COUNT, 2)]
    engines = {
        "jax_host": JaxMultiStreamPredictor(ckpt_path, tta=True, dtype=jnp.float32),
        "jax_device": JaxDeviceStateMultiStreamPredictor(ckpt_path, tta=True,
                                                         dtype=jnp.float32),
        "host": engine(MultiStreamPredictor, ckpt_path, tta=True),
        "device": engine(DeviceStateMultiStreamPredictor, ckpt_path, tta=True),
    }
    out = {}
    for name, multi in engines.items():
        source_frames = jax_frames if name.startswith("jax") else frames
        collected = out[name] = {}
        for tick in feed:
            for s, pred, pi in multi.predict_batch([(s, source_frames[s][i], i)
                                                    for s, i in tick]):
                if pred is not None:
                    collected[s, pi] = np.asarray(pred)
    # a window takes 11 frames: "a" feeds 40, "b" 38
    assert len(out["host"]) == (FRAME_COUNT - 10) + (FRAME_COUNT - 2 - 10)
    for name in ("host", "device"):
        assert set(out[name]) == set(out["jax_" + name])
        for key, pred in out[name].items():
            np.testing.assert_allclose(pred, out["jax_" + name][key], atol=JAX_ATOL, rtol=0,
                                       err_msg=f"{name} {key}")
    assert set(out["host"]) == set(out["device"])
