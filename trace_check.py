"""Check the port's tracer (``utils/profiling.py``) on one CUDA card, in
the benchmark's whole-match prediction cell.

    python3 trace_check.py --seed 3500000001 --seconds 30 [--out build/trace_check.json]

Sets the cell ``predict.b0_f15.tta`` up as ``benchmark/run.py`` does, then:

1. one segment at one offset with tracing off, with ``enable()``, and under
   ``torch.profiler``: the three predictions compared bit for bit;
2. the tracer's cost: ``predict_fps`` over ``--seconds`` windows, off and
   with ``enable()`` (no profiler) in turns, off on on off off on;
3. one traced segment as ``--trace 1`` traces it: the cell's per-layer
   metrics, the ten longest idle gaps on the device each put down to the
   innermost program span (``predict.*``) open at its midpoint on the
   trace's clock, the spans' per-chunk host ms and the encoder and head
   device ms against the window's busy time less the host-to-device copies,
   and whether any ``predict.*`` range was counted as device work.

Prints the card's name and power limit, then one JSON line per part, and
writes them all to ``--out``. Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark.run  # noqa: E402,F401  (the benchmark's caches in the checkout)
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ball_action_spotting_torch.utils import profiling  # noqa: E402
from benchmark import harness  # noqa: E402

CELL = "predict.b0_f15.tta"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def segment(traffic, offset: int):
    return traffic._segment(offset, traffic.p["segment_frames"])


def bitwise(traffic, device) -> dict:
    offset = int(traffic.offsets.integers(len(traffic.pool)))
    off = segment(traffic, offset)
    profiling.enable()
    on = segment(traffic, offset)
    profiling.disable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiled = segment(traffic, offset)
        sync(device)
    profiling.reset()
    return {"part": "bitwise", "offset": offset, "predictions": len(off),
            "on_equal": off.tobytes() == on.tobytes(),
            "profiled_equal": off.tobytes() == profiled.tobytes()}


def cost(traffic, seconds: float) -> dict:
    fps = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off", "off", "on"):
        if mode == "on":
            profiling.enable()
        fps[mode].append(traffic.window(seconds)["predict_fps"])
        profiling.disable()
        profiling.reset()
    med = {k: statistics.median(v) for k, v in fps.items()}
    return {"part": "cost", "seconds": seconds, "fps": fps, "median": med,
            "on_over_off": med["on"] / med["off"]}


def innermost(spans, t_ns: float):
    """The latest-opened span holding ``t_ns``, or None."""
    holding = [s for s in spans if s.start_ns <= t_ns <= s.end_ns]
    return max(holding, key=lambda s: s.start_ns) if holding else None


def traced(traffic, device) -> dict:
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traffic.traced_window()
        sync(device)
        window_s = time.perf_counter() - t0
    trace = harness.Trace(prof, window_s)
    metrics = {}
    for m in traffic.cell["per_layer"]:
        value = harness.metric_reader(m["name"]).read(traffic.context(trace))
        if value is not None:
            metrics[m["name"]] = value
    rec = profiling.records()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    merged = harness.merge_intervals([(s, e) for _, s, e in trace.kernels])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    by_id = {s.id: s for s in rec.spans}
    rows = []
    for (length, lo, hi), (label, _) in zip(gaps, trace.gaps):
        lo_ns, hi_ns = start_ns + lo * 1e3, start_ns + hi * 1e3
        span = innermost(rec.spans, (lo_ns + hi_ns) / 2)
        path = []
        while span is not None:
            path.append(span.name)
            span = by_id.get(span.parent)
        inside = innermost(rec.spans, lo_ns)
        # the host's spans just before and after the gap's midpoint, and how
        # far the gap's ends lie from them (us)
        before = max((s for s in rec.spans if s.end_ns <= (lo_ns + hi_ns) / 2),
                     key=lambda s: s.end_ns, default=None)
        after = min((s for s in rec.spans if s.start_ns >= (lo_ns + hi_ns) / 2),
                    key=lambda s: s.start_ns, default=None)
        rows.append({"ms": length / 1e3, "span": "/".join(reversed(path)) or None,
                     "whole_gap_in_span": bool(path) and inside is not None
                     and inside.end_ns >= hi_ns, "harness_label": label,
                     "at_ms": (lo_ns - rec.spans[0].start_ns) / 1e6 if rec.spans else None,
                     "after": before and [before.name, (lo_ns - before.end_ns) / 1e3],
                     "before": after and [after.name, (after.start_ns - hi_ns) / 1e3]})
    chunks = rec.counter("chunks")
    htod_s, htod_n = trace.kernel_seconds(lambda n: "Memcpy HtoD" in n)
    per_chunk = {name: (secs * 1e3 / chunks, n) for name, (secs, n) in
                 rec.totals("predict.").items()}
    encode_ms = metrics.get("encoder_ms.predict", 0.0) * chunks
    head_ms = metrics.get("head_ms.predict", 0.0) * chunks
    busy_less_htod_ms = (trace.busy_s - htod_s) * 1e3
    boot = [s.device_ms for s in rec.named("predict.encode")
            if by_id[s.parent].name == "predict.bootstrap"]
    return {"part": "traced", "window_s": window_s, "busy_s": trace.busy_s,
            "metrics": metrics, "counters": rec.counters(), "gaps": rows,
            "host_ms_per_chunk": per_chunk,
            "bench_upload_ms_per_chunk": metrics.get("upload_ms.predict"),
            "htod_ms_per_chunk": htod_s * 1e3 / chunks if chunks else None,
            "htod_copies": htod_n,
            "bootstrap_encode_ms": boot,
            "encoder_plus_head_ms": encode_ms + head_ms,
            "busy_less_htod_ms": busy_less_htod_ms,
            "ratio": (encode_ms + head_ms) / busy_less_htod_ms if busy_less_htod_ms else None,
            "predict_ranges_as_device_work": sorted(
                {n for n, _, _ in trace.kernels if n.startswith("predict.")}),
            "device_ops": trace.breakdown()["device_ops"]}


def run(cell: dict, seed: int, device, seconds: float):
    """The three parts' lines, in turn (a small cell and the CPU rehearse
    them)."""
    traffic = harness.traffic_module(cell["traffic"]).Traffic(cell, seed, device, traced=False)
    traffic.setup()
    yield bitwise(traffic, device)
    yield cost(traffic, seconds)
    traffic.spans.traced = True  # the benchmark's spans as ranges, as in ``--trace 1``
    traffic.spans.seconds.clear()  # the context counts the traced window's alone
    traffic.attempted = 0
    yield traced(traffic, device)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default="build/trace_check.json")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    lines = [{"part": "card", "card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda}]
    print(json.dumps(lines[-1]), flush=True)
    cell = harness.find_cell(CELL)
    for line in run(cell, args.seed, device, args.seconds):
        lines.append(line)
        print(json.dumps(line), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(lines, indent=1))
    ok = lines[1]["on_equal"] and lines[1]["profiled_equal"] and not lines[3][
        "predict_ranges_as_device_work"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
