"""A fixture of the benchmark's CPU tests (``benchmark/tests``), kept at the
root because both conftest levels under ``benchmark/`` hold fixtures of
their own.

``test_metric_readers_on_a_trace`` hands every reader a fake segment's
tracer records (``benchmark/tests/conftest.py`` feeds them through
``test_program_readers.feed_segment``). The 3D head's ``head.blocks3d``
span, read by ``blocks3d_ms.predict``, is not in them, so for that test the
fed segment also holds one ``head.blocks3d`` span, of 20 device ms, inside
each chunk's ``predict.head``. Imports nothing until that test runs."""

from __future__ import annotations

import pytest

BLOCKS3D_MS = 20.0


@pytest.fixture(autouse=True)
def blocks3d_span_in_fake_segment(request, monkeypatch):
    if request.node.originalname != "test_metric_readers_on_a_trace":
        yield
        return
    from ball_action_spotting_torch.utils import profiling
    from ball_action_spotting_torch.utils.profiling import Span
    from benchmark.tests import test_program_readers

    feed = test_program_readers.feed_segment

    def with_blocks3d(chunks, kept=None):
        feed(chunks, kept)
        rec = profiling.records()
        heads = rec.named("predict.head")
        next_id = max(s.id for s in rec.spans) + 1
        rec.spans.extend(Span("head.blocks3d", next_id + i, h.id, h.request, h.start_ns,
                              h.end_ns, device_ms=BLOCKS3D_MS) for i, h in enumerate(heads))

    # benchmark/tests/conftest.py imports feed_segment when its fixture runs,
    # after this one (autouse fixtures run from the root down)
    monkeypatch.setattr(test_program_readers, "feed_segment", with_blocks3d)
    yield
