"""What every cell shares: finding a cell, its configuration, its traffic
driver and its per-layer metrics by name; the device's description; the
trace of a window and the spans around calls into the program; the check
that no JAX module was loaded; the result line.

Everything that belongs to one configuration, traffic kind or metric lives
in a file of its own, found by the name that ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``cells/<cell>.json``, ``traffic/<kind>.py``,
``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ball_action_spotting_tpu")
# ranges that the profiler also lists on the device's timeline: the
# benchmark's spans and PyTorch's own record_function ranges, not work
ANNOTATIONS = ("bench.", "setup.", "ProfilerStep")


class HarnessError(RuntimeError):
    """A cell that cannot be run as asked: no card, a missing file."""


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise HarnessError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def benchmark_spec() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """The module of the file ``path``, loaded once under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise HarnessError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def find_cell(name: str, spec: dict | None = None) -> dict:
    """The cell's file, its configuration's file merged in as ``model``,
    and the metrics ``spec`` (``BENCHMARK.json``) gives it."""
    spec = spec or benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
    cell = read_json(HERE / "cells" / f"{name}.json")
    cell.update(name=name, config=entry["config"], traffic=entry["traffic"],
                chips=entry["chips"])
    cell["model"] = read_json(HERE / "configs" / f"{entry['config']}.json")
    cell["end_to_end"] = [m for m in spec["end_to_end"]
                          if name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if name in m.get("workloads", [name])
                         and any(e["name"] == m["moves"] for e in cell["end_to_end"])]
    return cell


def traffic_module(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_info(torch, chips: int) -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    limit = None
    if out.returncode == 0 and out.stdout.strip():
        limit = out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": limit,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


# --- spans and the traced window ------------------------------------------------------


class Spans:
    """Host-clock spans the benchmark records around calls into the
    program: name → list of seconds. In a traced run each span is also a
    ``record_function`` range, so the trace can say what the host was
    doing in a gap."""

    def __init__(self, torch, traced: bool):
        self.torch = torch
        self.traced = traced
        self.seconds: dict[str, list[float]] = {}
        self.setup: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (self.torch.profiler.record_function(name) if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def end_setup(self) -> None:
        """Keep the set-up's phases apart (seconds by name) and start the
        window's spans afresh."""
        self.setup = {k: sum(v) for k, v in self.seconds.items() if k.startswith("setup.")}
        self.seconds.clear()

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


def merge_intervals(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Trace:
    """A profiled window, reduced: device intervals by kernel name, their
    union (busy time), the window's length and the longest idle gaps
    labelled by the host's innermost benchmark span and operation."""

    def __init__(self, prof, window_s: float, span_prefix: str = "bench."):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.window_s = window_s
        self.kernels: list[tuple[str, float, float]] = []
        host: list[tuple[str, float, float]] = []
        for e in prof.events():
            if e.device_type != cuda:
                host.append((e.name, e.time_range.start, e.time_range.end))
            elif not (getattr(e, "is_user_annotation", False) or e.name.startswith(ANNOTATIONS)) \
                    and e.time_range.end > e.time_range.start:
                self.kernels.append((e.name, e.time_range.start, e.time_range.end))
        merged = merge_intervals([(s, e) for _, s, e in self.kernels])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.by_name: dict[str, list] = {}
        for name, s, e in self.kernels:
            slot = self.by_name.setdefault(name, [0.0, 0])
            slot[0] += (e - s) / 1e6
            slot[1] += 1
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        self.gaps = []
        for length, s, e in gaps[:10]:
            mid = (s + e) / 2
            around = [h for h in host if h[1] <= mid <= h[2]]
            spans = [h for h in around if h[0].startswith(span_prefix)]
            ops = [h for h in around if not h[0].startswith(span_prefix)
                   and not h[0].startswith("ProfilerStep")]
            label = "/".join(
                [min(spans, key=lambda h: h[2] - h[1])[0]] if spans else ["(no span)"]) + (
                "/" + min(ops, key=lambda h: h[2] - h[1])[0] if ops else "")
            self.gaps.append([label, length / 1e6])

    def kernel_seconds(self, match) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name ``match``
        accepts."""
        total, count = 0.0, 0
        for name, (secs, n) in self.by_name.items():
            if match(name):
                total += secs
                count += n
        return total, count

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name[:160], secs] for name, (secs, _) in top],
                "idle_gaps": self.gaps}


# --- the result line --------------------------------------------------------------------


def checks_ok(checks: list[dict]) -> bool:
    """Every compared number finite and within its limit."""
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list[dict], breakdown: dict | None = None) -> str:
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(line)
