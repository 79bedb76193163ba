"""The port's tracer (``utils/profiling.py``) on the CPU: off, it records
nothing; on, with ``enable()`` or under ``torch.profiler``, the prediction
path's spans nest, share a request id, sit on the profiler's clock, and its
counters match hand counts; predictions are the same bit for bit in every
case."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.blocks3d import SqueezeExcite3d
from ball_action_spotting_torch.models.effnetv2 import BatchNormAct, SqueezeExcite2d
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor
from ball_action_spotting_torch.utils import profiling
from ball_action_spotting_torch.utils.profiling import Records, Span

KW = dict(model_name="efficientnetv2_tiny", num_classes=2, num_frames=15, stack_size=3,
          index_2d_features=4, num_3d_blocks=2, num_3d_features=16, num_3d_stack_proj=8,
          expansion_3d_ratio=3, se_reduce_3d_ratio=8, drop_rate=0.0, drop_path_rate=0.0)
PARAMS = {"nn_module": ("multidim_stacker", KW), "frame_stack_size": 15, "frame_stack_step": 2,
          "frames_processor": ("pad_normalize", {"size": (96, 64)})}
CHUNK = 8
FRAMES = 75
LOOP = {"predict.pad", "predict.bootstrap", "predict.upload", "predict.dispatch",
        "predict.readback"}
HEAD = ("head.blocks3d", "head.pool")
ENGINES = {
    "feature_carry": dict(carry_features=True),
    "frame_carry": dict(carry_features=False),
    "spatial": dict(mesh=make_mesh(1, 2, ["cpu"] * 2), spatial=True),
    "int8_shares": dict(mesh=make_mesh(2, 1, ["cpu"] * 2), conv_int8=True),
}


@pytest.fixture(scope="module")
def weights():
    """Seeded tiny weights (the model's own init leaves some uninitialised)."""
    state = build_model("multidim_stacker", **KW).state_dict()
    g = torch.Generator().manual_seed(5)
    for key, v in state.items():
        if not v.is_floating_point():
            continue
        if key.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
        elif v.dim() > 1:
            v.copy_(torch.randn(v.shape, generator=g) / v[0].numel() ** 0.5)
        else:
            v.copy_(torch.randn(v.shape, generator=g) * 0.1 + key.endswith("weight"))
    return state, PARAMS


@pytest.fixture
def tracer():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def engine(weights, kind="feature_carry"):
    return ChunkedVideoPredictor(weights=weights, device="cpu", dtype=torch.float32,
                                 chunk_size=CHUNK, tta=True, **ENGINES[kind])


def video(frames=FRAMES, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (frames, 60, 96), dtype=np.uint8)


def predict(predictor, frames):
    return predictor.predict_video(enumerate(frames), len(frames))[1]


def test_off_records_nothing_and_predictions_match_on_and_profiled(weights, tracer):
    predictor, frames = engine(weights), video()
    off = predict(predictor, frames)
    assert not tracer.records().spans and not tracer.records().counts
    assert tracer.span("predict.segment") is tracer.span("predict.pad")  # no allocation
    tracer.enable()
    on = predict(predictor, frames)
    tracer.disable()
    assert tracer.records().spans
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = predict(predictor, frames)
    assert off.tobytes() == on.tobytes() == profiled.tobytes()


def profiled(predictor, frames, runs=2):
    """``runs`` predictions under the profiler → (records, {range name:
    its starts on ``time.time_ns``'s clock})."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for _ in range(runs):
            predict(predictor, frames)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith(("predict.", "head.")):
            ranges.setdefault(e.name, []).append(t0 + e.time_range.start * 1e3)
    return profiling.records(), ranges


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_spans_nest_with_one_request_per_call_on_the_profiler_clock(weights, tracer, kind):
    predictor, frames = engine(weights, kind), video()
    predict(predictor, frames)  # warm
    # each span is a host range of its name in the trace, started within 1 ms
    # of it. A thread descheduled between the two clock readings parts them
    # (5.8 ms with 12 busy processes beside the test), so the traced run is
    # made again, up to 3 times, until every span is within 1 ms.
    for _ in range(3):
        rec, ranges = profiled(predictor, frames)
        by_id = {s.id: s for s in rec.spans}
        bootstrap_encodes = [s for s in rec.named("predict.encode")
                             if by_id[s.parent].name == "predict.bootstrap"]
        assert set(ranges) == {s.name for s in rec.spans}
        worst = 0.0
        for name, starts in ranges.items():
            spans = sorted(s.start_ns for s in rec.named(name))
            if kind == "int8_shares" and name == "predict.encode":
                # the profiler is thread-local: the shares' encodes run in threads
                # of their own (``models/quantize.py::run_shares``), the bootstrap's not
                spans = sorted(s.start_ns for s in bootstrap_encodes)
            assert len(spans) == len(starts), name
            worst = max(worst, *(abs(a - b) for a, b in zip(spans, sorted(starts))))
        if worst < 1e6:
            break
    assert worst < 1e6
    segments = rec.named("predict.segment")
    assert len(segments) == 2 and all(s.parent is None for s in segments)
    assert len({s.request for s in segments}) == 2
    for s in rec.spans:
        assert s.end_ns >= s.start_ns
        if s.name == "predict.segment":
            continue
        assert s.request == by_id[s.parent].request
        parent = by_id[s.parent].name
        if s.name in LOOP:
            assert parent == "predict.segment", s
        elif s.name == "predict.head":
            assert parent == "predict.dispatch", s
        elif s.name.startswith("head."):  # the 3D blocks, and the projection to logits
            assert s.name in HEAD and parent == "predict.head", s
        else:
            assert s.name == "predict.encode" and parent in (
                "predict.dispatch", "predict.bootstrap"), (s, parent)
        assert s.device_ms is None or s.name in ("predict.encode", "predict.head", *HEAD)
    shares = len(predictor.shares)  # spatial: one data row
    chunks = rec.counter("chunks")
    assert len(bootstrap_encodes) == (2 if predictor.carry_features else 0)
    assert len(rec.named("predict.encode")) == len(bootstrap_encodes) + chunks * shares
    assert len(rec.named("predict.head")) == chunks * shares
    assert all(len(rec.named(name)) == chunks * shares for name in HEAD)
    assert all(s.device_ms == pytest.approx(s.ns / 1e6)
               for s in rec.spans if s.name in ("predict.encode", "predict.head", *HEAD))


@pytest.mark.parametrize("kind", ["feature_carry", "frame_carry"])
def test_counters_of_a_tiny_segment_equal_hand_counts(weights, tracer, kind):
    predictor, frames = engine(weights, kind), video()
    tracer.enable()
    _, raw = predictor.predict_video(enumerate(frames), len(frames))
    # 15 frames at step 2: 14 behind and 16 ahead of a prediction, so 75
    # frames keep 75 - 30 = 45 predictions, from frame 15 on; the loop skips
    # 15 - 14 = 1 frame, carries 28 (overlap) and computes ceil(45 / 8) = 6
    # chunks of 8 windows: it takes 1 + 28 + 48 = 77 frames, 2 past the end
    assert predictor.overlap == 28 and len(raw) == 45
    rec = tracer.records()
    counters = rec.counters()
    # every folded BN's epilogue takes the plain route on the CPU, once a call
    bns = [m for m in predictor.model.modules() if isinstance(m, BatchNormAct)]
    encoder_bns = 1 + sum(isinstance(m, BatchNormAct)
                          for m in predictor.model.conv2d_encoder.modules())
    assert counters.pop("bias_act.plain") == (
        encoder_bns * len(rec.named("predict.encode"))
        + (len(bns) - encoder_bns) * len(rec.named("predict.head")))
    # and every SE gate multiply, once a call
    encoder_ses = sum(isinstance(m, SqueezeExcite2d)
                      for m in predictor.model.conv2d_encoder.modules())
    head_ses = sum(isinstance(m, SqueezeExcite3d) for m in predictor.model.modules())
    assert encoder_ses > 0 and head_ses > 0
    assert counters.pop("se_scale.plain") == (encoder_ses * len(rec.named("predict.encode"))
                                              + head_ses * len(rec.named("predict.head")))
    # the 3D blocks take 48 windows × 2 views × 5 stacks
    assert counters == {
        "frames_in": 75, "frames_skipped": 1, "frames_repeated": 2, "chunks": 6,
        "windows_computed": 48, "predictions_kept": 45,
        "bytes_uploaded": (28 + 48) * 64 * 96, "head_stacks": 48 * 2 * 5}


def test_counts_belong_to_their_span_and_request(weights, tracer):
    predictor = engine(weights)
    tracer.enable()
    for seed in range(2):
        predict(predictor, video(seed=seed))
    rec = tracer.records()
    by_id = {s.id: s for s in rec.spans}
    for name, _, span_id in rec.counts:
        # a folded BN's epilogue or an SE scale, inside a model call
        if name.startswith(("bias_act.", "se_scale.")):
            assert by_id[span_id].name in ("predict.encode", *HEAD)
            continue
        if name == "head_stacks":  # the 3D head's stack maps, as it starts
            assert by_id[span_id].name == "predict.head"
            continue
        assert by_id[span_id].name == ("predict.pad" if name.startswith("frames_")
                                       and name != "frames_skipped" else "predict.segment")
    requests = {by_id[i].request for _, _, i in rec.counts}
    assert requests == {s.request for s in rec.named("predict.segment")} and len(requests) == 2


def test_self_time_excludes_children():
    parent = Span("predict.dispatch", 1, None, 1, 0, 100)
    rec = Records([parent, Span("predict.encode", 2, 1, 1, 10, 40),
                   Span("predict.head", 3, 1, 1, 30, 60),     # overlaps the encode
                   Span("predict.inner", 4, 3, 1, 35, 45),    # a grandchild: not subtracted
                   Span("predict.pad", 5, None, 1, 90, 200)])  # not a child
    assert rec.self_ns(parent) == 100 - 50
    assert rec.self_ns(rec.spans[2]) == 30 - 10
    assert rec.self_ns(rec.spans[4]) == 110
    assert [s.name for s in rec.ancestors(rec.spans[3])] == ["predict.head", "predict.dispatch"]


def test_self_time_of_a_traced_dispatch(weights, tracer):
    tracer.enable()
    predict(engine(weights), video())
    rec = tracer.records()
    for d in rec.named("predict.dispatch"):
        kids = [s for s in rec.spans if s.parent == d.id]
        assert {s.name for s in kids} == {"predict.encode", "predict.head"}
        assert rec.self_ns(d) == d.ns - sum(s.ns for s in kids) >= 0
    assert all(rec.self_ns(p) == p.ns for p in rec.named("predict.pad"))


def test_device_trace_exports_the_block_spans(weights, tmp_path, tracer):
    predictor = engine(weights)
    tracer.enable()
    predict(predictor, video())  # before the block: not exported
    before = len(tracer.records().spans)
    tracer.disable()
    with profiling.device_trace(tmp_path) as path:
        predict(predictor, video(seed=1))
    block = json.loads(path.with_suffix(".spans.json").read_text())
    assert len(block["spans"]) == len(tracer.records().spans) - before
    assert block["spans"][0]["name"] == "predict.segment"
    assert block["counters"]["predictions_kept"] == 45
    assert block["counters"]["head_stacks"] == 48 * 2 * 5  # windows × views × stacks
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "predict.dispatch" for e in events)


def test_predict_cli_trace_dir_writes_the_trace_and_spans(weights, tmp_path, monkeypatch,
                                                          tracer):
    from ball_action_spotting_torch.predict import __main__ as cli

    predictor = engine(weights)
    monkeypatch.setattr(cli, "predict_fold",
                        lambda args, fold, domain: predict(predictor, video()))
    cli.main(["--experiment", "tiny", "--folds", "0,1", "--device", "cpu",
              "--trace_dir", str(tmp_path / "trace")])
    [spans] = (tmp_path / "trace").glob("*.spans.json")
    block = json.loads(spans.read_text())
    assert len({s["request"] for s in block["spans"]}) == 2
    assert block["counters"]["chunks"] == 12
    assert spans.with_name(spans.name.replace(".spans", "")).exists()
