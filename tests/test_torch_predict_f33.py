"""The chunked engine with the stage-4 model's 33-frame windows (11 stacks
of 3 frames at step 2), on the CPU at the tiny size: against the plain
float32 reference (``benchmark/reference/model.py``) on seeded weights,
against the JAX package's engine through ``convert.py``, and traced, with
the 3D head's spans and stack count.

Tolerances: sigmoid predictions atol 1e-5, float32 on both sides, as the
other prediction tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.predict.streaming import (
    ChunkedVideoPredictor as JaxChunkedVideoPredictor,
)
from ball_action_spotting_tpu.train.checkpoint import save_checkpoint
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor
from ball_action_spotting_torch.utils import profiling
from benchmark.inputs import pad_frames
from benchmark.reference.model import Reference, calibrate_bn, seeded_weights
from tests.test_torch_models import register_port_tiny_arch, to_numpy_tree

register_port_tiny_arch()

KW = dict(model_name="efficientnetv2_tiny", num_classes=2, num_frames=33, stack_size=3,
          index_2d_features=4, num_3d_blocks=2, num_3d_features=16, num_3d_stack_proj=8,
          expansion_3d_ratio=3, se_reduce_3d_ratio=8, drop_rate=0.0, drop_path_rate=0.0,
          act_layer="silu")
STEP = 2
BEHIND = (33 // 2) * STEP  # frames a window reaches back (and ahead) of its centre
PARAMS = {"nn_module": ("multidim_stacker", KW), "frame_stack_size": 33,
          "frame_stack_step": STEP, "frames_processor": ("pad_normalize", {"size": (96, 64)})}
CHUNK = 8
# two segments: 85 frames keep 85 - 66 = 19 predictions in 3 chunks of 8 (the
# last padded by 5), 78 frames keep 12 in 2 (the last padded by 4)
SEGMENTS = (85, 78)
ATOL = 1e-5


def video(frames, seed):
    """``frames`` uint8 frames of 60×96, which the engine pads to 64×96."""
    return np.random.default_rng(seed).integers(0, 255, (frames, 60, 96), dtype=np.uint8)


@pytest.fixture(scope="module")
def weights():
    """Seeded reference weights, every BN's statistics set from one clip."""
    w = seeded_weights(KW, 23, "cpu")
    clip = pad_frames(video(33, 99), (96, 64))
    calibrate_bn(w, KW, torch.from_numpy(clip)[None].float() / 255.0)
    return w


def reference_predictions(w, frames, idx, tta):
    """The float32 reference's sigmoid predictions at frames ``idx`` of
    ``frames``: each window the 33 frames at step 2 around its frame, hflip
    TTA the mean of both views' sigmoids."""
    ref = Reference(w, KW)
    clips = np.stack([pad_frames(frames[c - BEHIND + np.arange(33) * STEP], (96, 64))
                      for c in idx])
    x = torch.from_numpy(clips).float() / 255.0
    views = [x, x.flip(-1)] if tta else [x]
    with torch.no_grad():
        return torch.stack([torch.sigmoid(ref.forward(v)) for v in views]).mean(0).numpy()


@pytest.mark.parametrize("carry_features", [True, False])
@pytest.mark.parametrize("tta", [False, True])
def test_33_frame_engine_matches_the_plain_reference(weights, tta, carry_features):
    engine = ChunkedVideoPredictor(weights=({k: v.clone() for k, v in weights.items()}, PARAMS),
                                   device="cpu", dtype=torch.float32, chunk_size=CHUNK,
                                   tta=tta, carry_features=carry_features)
    assert engine.num_stacks == 11 and engine.overlap == 64
    for seed, count in enumerate(SEGMENTS):
        frames = video(count, seed)
        idx, raw = engine.predict_video(enumerate(frames), count)
        assert list(idx) == list(range(BEHIND + 1, count - BEHIND - 1))
        assert raw.shape == (count - 2 * BEHIND - 2, 2) and raw.dtype == np.float32
        want = reference_predictions(weights, frames, idx, tta)
        np.testing.assert_allclose(raw, want, atol=ATOL)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX checkpoint of the 33-frame tiny model (the JAX package's test
    arch), with randomized BN statistics."""
    kw = dict(KW, model_name="efficientnetv2_test")
    model = jax_build_model("multidim_stacker", **kw)
    variables = model.init({"params": jax.random.PRNGKey(4)},
                           jnp.zeros((1, 33, 64, 96), jnp.float32), train=False)
    path = tmp_path_factory.mktemp("ckpt33") / "model-001-0.500000.ckpt"
    save_checkpoint(path, dict(PARAMS, nn_module=("multidim_stacker", kw)),
                    to_numpy_tree(variables, 4))
    return path


@pytest.mark.parametrize("carry_features", [True, False])
@pytest.mark.parametrize("tta", [False, True])
def test_33_frame_engine_matches_jax(jax_ckpt, tta, carry_features):
    frames = video(SEGMENTS[0], 7)
    j_idx, j_raw = JaxChunkedVideoPredictor(
        jax_ckpt, tta=tta, dtype=jnp.float32, chunk_size=CHUNK,
        carry_features=carry_features).predict_video(enumerate(frames), len(frames))
    engine = ChunkedVideoPredictor(jax_ckpt, tta=tta, dtype=torch.float32, chunk_size=CHUNK,
                                   carry_features=carry_features, device="cpu")
    idx, raw = engine.predict_video(enumerate(frames), len(frames))
    assert list(idx) == list(j_idx) and len(idx) == SEGMENTS[0] - 2 * BEHIND - 2
    np.testing.assert_allclose(raw, j_raw, atol=ATOL)


@pytest.mark.parametrize("tta", [False, True])
def test_a_traced_chunk_records_the_head_spans_and_stacks(weights, tta):
    engine = ChunkedVideoPredictor(weights=({k: v.clone() for k, v in weights.items()}, PARAMS),
                                   device="cpu", dtype=torch.float32, chunk_size=CHUNK,
                                   tta=tta)
    # 74 frames keep 8 predictions: one chunk, no padding
    frames = video(74, 3)
    untraced = engine.predict_video(enumerate(frames), len(frames))[1]
    profiling.reset()
    profiling.enable()
    try:
        traced = engine.predict_video(enumerate(frames), len(frames))[1]
    finally:
        profiling.disable()
    rec = profiling.records()
    profiling.reset()
    assert traced.tobytes() == untraced.tobytes()
    [head] = rec.named("predict.head")
    by_parent = {name: [s for s in rec.named(name) if s.parent == head.id]
                 for name in ("head.blocks3d", "head.pool")}
    assert all(len(spans) == 1 for spans in by_parent.values())
    assert len(rec.named("head.blocks3d")) == len(rec.named("head.pool")) == 1
    blocks, pool = by_parent["head.blocks3d"][0], by_parent["head.pool"][0]
    assert head.start_ns <= blocks.start_ns <= blocks.end_ns <= pool.start_ns <= head.end_ns
    assert blocks.device_ms is not None and pool.device_ms is not None
    views = 2 if tta else 1
    assert rec.counter("chunks") == 1
    assert rec.counter("head_stacks") == CHUNK * views * 11
