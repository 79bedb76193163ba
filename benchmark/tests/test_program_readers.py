"""CPU tests of the readers of the program's own spans and counters
(``pad_ms``, ``encoder_ms``, ``head_ms``, ``kept_share``): a tiny traced
run gives all four, each reads nothing where the program recorded nothing
or has no tracer, and the helpers that feed a fake segment's records to the
other readers' test."""

from __future__ import annotations

import pytest

from ball_action_spotting_torch.utils import profiling
from ball_action_spotting_torch.utils.profiling import Span
from benchmark import harness
from benchmark.tests.test_benchmark_harness import run_tiny
from benchmark.tests.tiny import tiny_cell

READERS = ("pad_ms.predict", "encoder_ms.predict", "head_ms.predict", "kept_share.predict")
CELL = "predict.b0_f15.tta"
MS = 1_000_000


def feed_segment(chunks: int, kept: int | None = None) -> None:
    """The tracer's records of one fake segment of ``chunks`` chunks of 128
    windows: a 30-ms pad, a 20-ms upload and a dispatch each, the dispatch
    holding an encode of 200 device ms and a head of 25; the bootstrap's
    encode 40 device ms."""
    profiling.reset()
    rec = profiling.records()
    spans = [Span("predict.segment", 1, None, 1, 0, (100 + 300 * chunks) * MS),
             Span("predict.pad", 2, 1, 1, 0, 5 * MS),
             Span("predict.bootstrap", 3, 1, 1, 5 * MS, 60 * MS),
             Span("predict.encode", 4, 3, 1, 10 * MS, 50 * MS, device_ms=40.0)]
    for c in range(chunks):
        t, i = (100 + 300 * c) * MS, 5 + 5 * c
        spans += [Span("predict.pad", i, 1, 1, t, t + 30 * MS),
                  Span("predict.upload", i + 1, 1, 1, t + 30 * MS, t + 50 * MS),
                  Span("predict.dispatch", i + 2, 1, 1, t + 50 * MS, t + 60 * MS),
                  Span("predict.encode", i + 3, i + 2, 1, t + 51 * MS, t + 55 * MS,
                       device_ms=200.0),
                  Span("predict.head", i + 4, i + 2, 1, t + 55 * MS, t + 59 * MS,
                       device_ms=25.0)]
    rec.spans.extend(spans)
    rec.counts += [("chunks", chunks, 1), ("windows_computed", 128 * chunks, 1),
                   ("predictions_kept", 128 * chunks - 6 if kept is None else kept, 1)]


def clear_records() -> None:
    profiling.reset()


def read(name):
    return harness.metric_reader(name).read(None)


def test_fed_segment_reads_as_built():
    feed_segment(24, kept=2970)
    try:
        assert [read(n) for n in READERS] == [30.0, 200.0, 25.0,
                                              pytest.approx(2970 / 3072 * 100)]
    finally:
        clear_records()


def test_the_readers_read_nothing_without_records(monkeypatch):
    clear_records()
    assert [read(n) for n in READERS] == [None] * 4
    feed_segment(8)
    try:
        # a program whose tracer has no ``records`` (the parent of the tracer)
        monkeypatch.delattr(profiling, "records")
        assert [read(n) for n in READERS] == [None] * 4
    finally:
        clear_records()


def test_a_tiny_traced_run_gives_all_four():
    # 75 frames keep 75 - 30 = 45 predictions in ceil(45 / 8) = 6 chunks of 8
    cell = tiny_cell(CELL, segment_frames=75)
    clear_records()
    try:
        correct, line = run_tiny(cell, trace=1)
        assert correct
        metrics = line["metrics"]
        assert set(READERS) <= set(metrics)
        assert metrics["kept_share.predict"]["value"] == pytest.approx(45 / 48 * 100)
        assert all(metrics[n]["value"] > 0 for n in READERS)
        records = profiling.records()
        assert records.counter("chunks") == 6 and len(records.named("predict.segment")) == 1
    finally:
        clear_records()
    # an untraced run records nothing
    correct, line = run_tiny(cell)
    assert correct and not profiling.records().spans and not profiling.records().counts
