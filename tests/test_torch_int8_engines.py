"""Every engine that takes ``conv_int8`` against the JAX package's same
engine with ``conv_int8=True`` on the CPU, from one tiny ``.ckpt`` written
by the port's own writer (``tests/test_torch_fused.py::make_ckpt``), after
``tests/test_quantize.py::test_int8_through_chunked_predictor``.

The scale of every int8 conv is the max over the whole batch JAX's conv
sees, so the port's split batches (data shares on a grid, height bands)
must take one scale over every share and band.

Tolerances (float32 on both sides), measured against the int8 drift, the
sigmoids' distance from the float32 engine's (the port's float32 engine,
6e-8 from JAX's here): the mean |port − JAX| at most a tenth of the mean
drift, as ``tests/test_torch_quantize.py`` holds the encoder, and the max
at most half the max drift. Float32 sums in another order upstream move a
value across a rounding boundary and change it by one int8 step: on these
inputs up to 5 of 56 predictions move by more than 1e-6, the most by
1.43e-5 (0.42 of the max drift, 0.033 of the mean), in the frame-carry
TTA-off batch; the drift itself is 3.2e-5 to 4.1e-5. Every grid against
JAX's engine on its 8 CPU devices by the same measure. JAX's own bound of
its int8 drift, max |Δ| < 0.15 on the sigmoids, holds on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ball_action_spotting_tpu.predict.multistream import (
    DeviceStateMultiStreamPredictor as JaxDeviceStateMultiStreamPredictor,
    MultiStreamPredictor as JaxMultiStreamPredictor,
)
from ball_action_spotting_tpu.predict.streaming import (
    ChunkedVideoPredictor as JaxChunkedVideoPredictor,
    StreamingPredictor as JaxStreamingPredictor,
    get_raw_predictions as jax_get_raw_predictions,
    iter_source_frames as jax_iter_source_frames,
)
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models.quantize import QuantConv
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.export import (
    ExportedChunkPredictor,
    export_chunked_predictor,
)
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.multistream import (
    DeviceStateMultiStreamPredictor,
    MultiStreamPredictor,
)
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    StreamingPredictor,
    get_raw_predictions,
    iter_source_frames,
)
from tests.test_torch_fused import FRAME_COUNT, SRC_KWARGS, make_ckpt

MEAN_OF_DRIFT = 0.1   # mean |port − JAX| over the mean int8 drift
MAX_OF_DRIFT = 0.5    # max |port − JAX| over the max int8 drift: a flipped step's reach
JAX_INT8_DRIFT = 0.15  # tests/test_quantize.py's bound against the float32 engine
F32 = dict(dtype=torch.float32, conv_int8=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("int8") / "model-001-0.500000.ckpt")


def assert_int8_close(got: np.ndarray, ref: np.ndarray, f32: np.ndarray) -> None:
    """The port's int8 predictions ``got`` against JAX's ``ref``, measured
    against the drift of ``ref`` from the float32 predictions ``f32``."""
    diff, drift = np.abs(got - ref), np.abs(ref - f32)
    assert drift.max() < JAX_INT8_DRIFT
    assert diff.mean() <= MEAN_OF_DRIFT * drift.mean(), (diff.mean(), drift.mean())
    assert diff.max() <= MAX_OF_DRIFT * drift.max(), (diff.max(), drift.max())


def keyed(out: dict) -> np.ndarray:
    return np.stack([out[k] for k in sorted(out)])


def port_video(engine):
    return engine.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)), FRAME_COUNT)


def jax_video(engine):
    idx, raw = engine.predict_video(jax_iter_source_frames(JaxSyntheticSource(**SRC_KWARGS)),
                                    FRAME_COUNT)
    return list(idx), np.asarray(raw)


@pytest.mark.parametrize("carry_features,tta", [(True, False), (True, True), (False, False),
                                                (False, True)])
def test_chunked_int8_matches_jax(ckpt_path, carry_features, tta):
    """Feature and frame carry, TTA on and off (each carry quantizes over
    its own encoder batch: the N new stacks, or N + (S−1)·span), against
    JAX's engine; and JAX's drift bound against the float32 engine."""
    kw = dict(chunk_size=16, tta=tta, carry_features=carry_features)
    engine = ChunkedVideoPredictor(ckpt_path, device="cpu", **F32, **kw)
    assert sum(isinstance(m, QuantConv) for m in engine.model.modules()) == 11
    idx, raw = port_video(engine)
    j_idx, j_raw = jax_video(JaxChunkedVideoPredictor(ckpt_path, dtype=jnp.float32,
                                                      conv_int8=True, **kw))
    assert list(idx) == j_idx and raw.shape == (28, 2) and np.isfinite(raw).all()
    _, f32 = port_video(ChunkedVideoPredictor(ckpt_path, device="cpu", dtype=torch.float32,
                                              **kw))
    assert_int8_close(raw, j_raw, f32)


def test_streaming_int8_matches_jax(ckpt_path):
    engine = StreamingPredictor(ckpt_path, device="cpu", tta=True, **F32)
    idx, raw = get_raw_predictions(engine, SyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    j_idx, j_raw = jax_get_raw_predictions(
        JaxStreamingPredictor(ckpt_path, tta=True, dtype=jnp.float32, conv_int8=True),
        JaxSyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    assert list(idx) == list(j_idx)
    _, f32 = get_raw_predictions(StreamingPredictor(ckpt_path, device="cpu", tta=True,
                                                    dtype=torch.float32),
                                 SyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    assert_int8_close(raw, np.asarray(j_raw), f32)


def multistream_feed(seeds: dict, cls=SyntheticSource) -> tuple[dict, list]:
    """Two streams' frames, and a feed: staggered admission, then a backlog
    tick of two frames per stream, then a ragged tick (two frames of one
    stream, one of the other)."""
    frames = {}
    for s, seed in seeds.items():
        src = cls(**{**SRC_KWARGS, "seed": seed})
        frames[s] = [src.fetch_frame() for _ in range(FRAME_COUNT)]
    feed = [[("a", 0)], [("a", 1)]] + [[("a", i), ("b", i - 2)] for i in range(2, 20)]
    feed += [[("a", i), ("a", i + 1), ("b", i - 2), ("b", i - 1)] for i in range(20, 30, 2)]
    feed += [[("a", 30), ("a", 31), ("b", 28)], [("a", 32), ("b", 29), ("b", 30)]]
    feed += [[("a", i), ("b", i - 2)] for i in range(33, FRAME_COUNT)]
    return frames, feed


def run_feed(multi, frames: dict, feed: list) -> dict:
    out = {}
    for tick in feed:
        for s, pred, pi in multi.predict_batch([(s, frames[s][i], i) for s, i in tick]):
            if pred is not None:
                out[s, pi] = np.asarray(pred)
    return out


def test_multistream_int8_engines_match_jax(ckpt_path):
    """Both multi-stream engines against JAX's on one feed. The scale is the
    padded bucket's: the host-state engine pads with repeats of the last
    row, the device-state tick encodes every slot of its bucket, stale ring
    rows and zero frames included, as JAX's do."""
    seeds = {"a": 10, "b": 11}
    frames, feed = multistream_feed(seeds)
    jax_frames, _ = multistream_feed(seeds, JaxSyntheticSource)
    engines = {
        "jax_host": JaxMultiStreamPredictor(ckpt_path, tta=True, dtype=jnp.float32,
                                            conv_int8=True),
        "jax_device": JaxDeviceStateMultiStreamPredictor(ckpt_path, tta=True,
                                                         dtype=jnp.float32, conv_int8=True),
        "host": MultiStreamPredictor(ckpt_path, tta=True, device="cpu", **F32),
        "device": DeviceStateMultiStreamPredictor(ckpt_path, tta=True, device="cpu", **F32),
        "f32": MultiStreamPredictor(ckpt_path, tta=True, device="cpu", dtype=torch.float32),
    }
    out = {name: run_feed(multi, jax_frames if name.startswith("jax") else frames, feed)
           for name, multi in engines.items()}
    assert len(out["host"]) == (FRAME_COUNT - 10) + (FRAME_COUNT - 2 - 10)
    for name in ("host", "device"):
        assert set(out[name]) == set(out["jax_" + name]) == set(out["f32"])
        assert_int8_close(keyed(out[name]), keyed(out["jax_" + name]), keyed(out["f32"]))


@pytest.fixture(scope="module")
def jax_spatial_int8(ckpt_path):
    """JAX's int8 spatial engine on a (data=2, model=4) mesh of its 8 CPU
    devices."""
    return jax_video(JaxChunkedVideoPredictor(ckpt_path, dtype=jnp.float32, chunk_size=16,
                                              mesh=jax_make_mesh(2, 4), spatial=True,
                                              conv_int8=True))


@pytest.mark.parametrize("grid", [(1, 2), (2, 4)])
def test_spatial_int8_matches_jax(ckpt_path, jax_spatial_int8, grid):
    """The spatial engine over the CPU repeated on a (1, 2) and a (2, 4)
    grid (two data rows, each in its thread of one scale group, four bands
    a row, the last empty at 1/32) against JAX's on (2, 4)."""
    n_data, n_model = grid
    engine = ChunkedVideoPredictor(ckpt_path, chunk_size=16, spatial=True, **F32,
                                   mesh=make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model)))
    idx, raw = port_video(engine)
    j_idx, j_raw = jax_spatial_int8
    assert list(idx) == j_idx
    _, f32 = port_video(ChunkedVideoPredictor(ckpt_path, device="cpu", dtype=torch.float32,
                                              chunk_size=16, carry_features=False))
    assert_int8_close(raw, j_raw, f32)


def test_data_mesh_int8_matches_jax(ckpt_path):
    """``ChunkedVideoPredictor(mesh=)`` with 8 data shares (each encodes 2
    of the chunk's 16 new stacks in its thread of one scale group) against
    JAX's engine on its 8-device data mesh, and the serving mesh
    (``MultiStreamPredictor(mesh=)``, buckets of 8 rows in 8 shares)
    against JAX's on the same mesh."""
    kw = dict(chunk_size=16, tta=True)
    _, raw = port_video(ChunkedVideoPredictor(ckpt_path, mesh=make_mesh(8, 1, ["cpu"] * 8),
                                              **F32, **kw))
    _, j_raw = jax_video(JaxChunkedVideoPredictor(ckpt_path, dtype=jnp.float32, conv_int8=True,
                                                  mesh=jax_make_mesh(8, 1), **kw))
    _, f32 = port_video(ChunkedVideoPredictor(ckpt_path, device="cpu", dtype=torch.float32,
                                              **kw))
    assert_int8_close(raw, j_raw, f32)

    seeds = {"a": 12, "b": 13}
    frames, feed = multistream_feed(seeds)
    jax_frames, _ = multistream_feed(seeds, JaxSyntheticSource)
    got = run_feed(MultiStreamPredictor(ckpt_path, mesh=make_mesh(8, 1, ["cpu"] * 8), **F32),
                   frames, feed[:24])
    ref = run_feed(JaxMultiStreamPredictor(ckpt_path, dtype=jnp.float32, conv_int8=True,
                                           mesh=jax_make_mesh(8, 1)), jax_frames, feed[:24])
    f32 = run_feed(MultiStreamPredictor(ckpt_path, device="cpu", dtype=torch.float32),
                   frames, feed[:24])
    assert set(got) == set(ref) == set(f32) and got
    assert_int8_close(keyed(got), keyed(ref), keyed(f32))


def test_int8_export_holds_the_op_and_reloads_equal(ckpt_path, tmp_path):
    """An int8 chunked engine traced on the CPU: the artifact holds one
    ``bas_torch::int8_conv2d`` node per quantized conv (the 9 that are not
    depthwise) and reloads equal to the live frame-carry engine."""
    live = ChunkedVideoPredictor(ckpt_path, device="cpu", chunk_size=16, dw3d_use_kernel=True,
                                 carry_features=False, **F32)
    art = export_chunked_predictor(live, tmp_path / "int8.bastorx")
    sealed = ExportedChunkPredictor(art, device="cpu")
    targets = [str(n.target) for n in sealed.program.graph.nodes if n.op == "call_function"]
    assert targets.count("bas_torch.int8_conv2d.default") == 9
    idx, raw = sealed.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)),
                                    FRAME_COUNT)
    l_idx, l_raw = port_video(live)
    assert list(idx) == list(l_idx)
    np.testing.assert_allclose(raw, l_raw, atol=1e-6, rtol=0)


def test_fused_folds_refuses_conv_int8(ckpt_path):
    """As JAX's ``FusedFoldsPredictor``, which takes no ``conv_int8``."""
    with pytest.raises(TypeError):
        FusedFoldsPredictor([ckpt_path], device="cpu", conv_int8=True)
