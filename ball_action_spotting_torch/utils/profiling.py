"""The port's tracer, and the device trace that exports it (port of the JAX
package's ``utils/profiling.py``, which has a device trace, a stage timer
and ``synchronize``).

Spans and counters are recorded while a ``torch.profiler`` is on, or after
``enable()``; otherwise ``span`` and ``count`` are one flag test each and
record nothing. A span keeps its name, its start and end on
``time.time_ns()`` (the clock the profiler's trace starts from:
``prof.profiler.kineto_results.trace_start_ns()``), the span it ran inside
and a request id: ``span(..., request=True)`` draws one, the spans inside
it share it. While a profiler is on, each span is also a
``record_function`` range of its name, so the trace's timeline shows it
(in the threads the profiler traces: those a share of ``run_shares`` runs
in are not).
``span(..., device=d)`` also times the work queued on ``d`` inside the span:
on a CUDA device a timing-enabled event pair on ``d``'s current stream,
resolved (``elapsed_time``) only when the records are read; on the CPU the
work runs in the span, and its device time is the span's own. Nothing here
synchronizes a device. A counter adds to a named total, and remembers the
span it was counted in.

Usage::

    with device_trace("traces") as path:   # Chrome trace, and the spans as JSON
        run_steps()

    enable()
    with span("decode"):
        ...
    count("frames_in", 128)
    print(records().report())
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import time
from pathlib import Path
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span. ``parent`` and ``request`` are ids (None outside
    any span or request); ``device_ms`` is the device time of a span opened
    with ``device=``, once resolved."""

    name: str
    id: int
    parent: int | None
    request: int | None
    start_ns: int
    end_ns: int = 0
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)  # (start, end)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Records:
    """What the tracer recorded: spans in the order they opened, and counts
    as (counter, amount, id of the innermost open span or None)."""

    spans: list[Span] = dataclasses.field(default_factory=list)
    counts: list[tuple[str, int, int | None]] = dataclasses.field(default_factory=list)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def counter(self, name: str) -> int:
        return sum(n for c, n, _ in self.counts if c == name)

    def counters(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name, n, _ in self.counts:
            out[name] = out.get(name, 0) + n
        return out

    def ancestors(self, span: Span) -> list[Span]:
        """The spans ``span`` ran inside, innermost first."""
        by_id = {s.id: s for s in self.spans}
        out = []
        while span.parent in by_id:
            span = by_id[span.parent]
            out.append(span)
        return out

    def self_ns(self, span: Span) -> int:
        """``span``'s duration less the part of it its children cover."""
        covered, end = 0, span.start_ns
        for child in sorted((s for s in self.spans if s.parent == span.id),
                            key=lambda s: s.start_ns):
            lo, hi = max(child.start_ns, end), min(child.end_ns, span.end_ns)
            if hi > lo:
                covered += hi - lo
                end = hi
        return span.ns - covered

    def totals(self, prefix: str = "") -> dict[str, tuple[float, int]]:
        """(seconds, spans) by the name of every span whose name starts
        with ``prefix``."""
        out: dict[str, tuple[float, int]] = {}
        for s in self.spans:
            if s.name.startswith(prefix):
                secs, n = out.get(s.name, (0.0, 0))
                out[s.name] = (secs + s.ns / 1e9, n + 1)
        return out

    def report(self, prefix: str = "") -> str:
        """One line a span name, the largest total first."""
        totals = self.totals(prefix)
        return "\n".join(
            f"{name}: total {secs:.3f}s, {n} calls, {secs / n * 1000:.2f} ms/call"
            for name, (secs, n) in sorted(totals.items(), key=lambda kv: -kv[1][0]))

    def to_json(self) -> dict:
        return {"spans": [{k: getattr(s, k) for k in ("name", "id", "parent", "request",
                                                       "start_ns", "end_ns", "device_ms")}
                          for s in self.spans],
                "counters": self.counters()}


class _Open:
    """A span being recorded (the context manager ``span`` returns when the
    tracer is on)."""

    __slots__ = ("tracer", "name", "device", "request", "span", "token", "range")

    def __init__(self, tracer: "Tracer", name: str, device, request: bool):
        self.tracer, self.name, self.device, self.request = tracer, name, device, request

    def __enter__(self) -> Span:
        tracer = self.tracer
        parent = tracer.current.get()
        request = next(tracer.request_ids) if self.request else (
            parent.request if parent is not None else None)
        span = Span(self.name, next(tracer.span_ids),
                    parent.id if parent is not None else None, request, 0)
        if self.device is not None and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            span.events = (start, None)
        # the profiler is thread-local: a thread it does not trace gets no range
        self.range = (torch.profiler.record_function(self.name)
                      if torch._C._autograd._profiler_enabled() else None)
        span.start_ns = time.time_ns()  # next to the range's own start
        if self.range is not None:
            self.range.__enter__()
        self.token = tracer.current.set(span)
        tracer.held.spans.append(span)
        self.span = span
        return span

    def __exit__(self, *exc) -> None:
        span = self.span
        if span.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            span.events = (span.events[0], end)
        if self.range is not None:
            self.range.__exit__(*exc)
        span.end_ns = time.time_ns()
        if self.device is not None and self.device.type == "cpu":
            span.device_ms = span.ns / 1e6
        self.tracer.current.reset(self.token)


class Tracer:
    """Spans and counters of one process (see the module docstring)."""

    def __init__(self):
        self.enabled = False
        self.held = Records()
        self.current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
            "profiling_span", default=None)
        self.span_ids = itertools.count(1)
        self.request_ids = itertools.count(1)

    def span(self, name: str, device: torch.device | None = None, request: bool = False):
        """A context manager that records a span named ``name`` while the
        tracer is on; ``device`` times the work queued on it, ``request``
        draws a new request id."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, device, request)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled or _autograd_profiler._is_profiler_enabled:
            parent = self.current.get()
            self.held.counts.append((name, n, parent.id if parent is not None else None))

    def read(self) -> Records:
        """The records, each device time whose events have completed
        resolved (a span whose work is still queued keeps ``device_ms``
        None; nothing waits)."""
        for s in self.held.spans:
            if s.events is not None and s.events[1] is not None and s.events[1].query():
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        return self.held

    def reset(self) -> None:
        self.held = Records()


_OFF = contextlib.nullcontext()
TRACER = Tracer()
span, count, records, reset = TRACER.span, TRACER.count, TRACER.read, TRACER.reset


def enable() -> None:
    """Record spans and counters without a profiler, until ``disable()``."""
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


@contextlib.contextmanager
def device_trace(log_dir: str | Path) -> Iterator[Path]:
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA's
    where a CUDA device is present) and write a Chrome trace into
    ``log_dir``, and beside it (``.spans.json``) the tracer's spans and
    counters of the block; yields the trace file's path, written when the
    block ends."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first_span, first_count = len(TRACER.held.spans), len(TRACER.held.counts)
    with profile(activities=activities) as prof:  # the profiler turns the tracer on
        yield path
        if torch.cuda.is_available():  # the block's device work, in the trace
            for index in range(torch.cuda.device_count()):
                torch.cuda.synchronize(index)
    prof.export_chrome_trace(str(path))
    held = records()
    block = Records(held.spans[first_span:], held.counts[first_count:])
    path.with_suffix(".spans.json").write_text(json.dumps(block.to_json()))


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def synchronize(tree) -> None:
    """Wait for all work queued on the CUDA devices of the tensors in
    ``tree`` (nested dicts, lists and tuples); CPU tensors need no wait."""
    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
