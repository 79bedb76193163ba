"""Fixtures of the benchmark's CPU tests.

``test_metric_readers_on_a_trace`` hands every reader a fake context. The
readers of the program's own spans and counters (``pad_ms``, ``encoder_ms``,
``head_ms``, ``kept_share``) read the tracer's records instead, so for that
test a fake segment's records are fed into the tracer before it runs and
cleared after it."""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def program_records(request):
    if request.node.originalname != "test_metric_readers_on_a_trace":
        yield
        return
    from benchmark.tests.test_program_readers import clear_records, feed_segment

    feed_segment(8)  # the fake context's chunks
    try:
        yield
    finally:
        clear_records()
