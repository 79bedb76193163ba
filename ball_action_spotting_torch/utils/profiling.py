"""Profiling and tracing utilities (port of the JAX package's
``utils/profiling.py``): a device trace through ``torch.profiler``, an
accumulating wall-clock timer for host stages, and a synchronize that waits
for the devices of a tree of tensors.

Usage::

    with device_trace("traces") as path:   # Chrome trace, chrome://tracing
        run_steps()

    timer = StageTimer()
    with timer.stage("decode"):
        ...
    print(timer.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str | Path) -> Iterator[Path]:
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA's
    where a CUDA device is present) and write a Chrome trace into
    ``log_dir``; yields the trace file's path, written when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():  # the block's device work, in the trace
            for index in range(torch.cuda.device_count()):
                torch.cuda.synchronize(index)
    prof.export_chrome_trace(str(path))


class StageTimer:
    """Accumulating wall-clock timer for host pipeline stages."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(
                f"{name}: total {total:.3f}s, {count} calls, "
                f"{total / count * 1000:.2f} ms/call"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


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

