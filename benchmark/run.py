"""Run one cell of the benchmark of ``ball_action_spotting_torch`` once.

    python3 benchmark/run.py --workload predict.b0_f15.tta --seed 7 --seconds 30 --trace 0

Loads the cell (``cells/<name>.json``), its configuration
(``configs/<config>.json``) and its traffic driver (``traffic/<kind>.py``),
sets up (weights and inputs from ``--seed``, every shape of the cell warmed
up), measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
traces a fixed stretch of the same traffic (``--trace 1``: the per-layer
metrics of ``metrics/<name>.py``), compares what the timed path produced
with the plain reference, and prints one JSON line last. Without as many
CUDA cards as the cell asks for it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run lives at a fixed path in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, device=None, cell=None, t_start=None, hook=None) -> tuple[bool, str]:
    """One run of a cell: (correct, the result line). ``device`` and
    ``cell`` default to the first CUDA card and the cell of
    ``BENCHMARK.json``; tests pass a CPU device, a small cell and a
    ``hook`` that breaks the program object before its first call."""
    import torch

    t_start = T_START if t_start is None else t_start
    cell = cell or harness.find_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise harness.HarnessError(
                f"{args.workload} needs {cell['chips']} CUDA card(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    traffic = harness.traffic_module(cell["traffic"]).Traffic(
        cell, args.seed, device, traced=bool(args.trace))
    traffic.program_hook = hook
    traffic.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print("setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           traffic.spans.setup.items()), file=sys.stderr)

    breakdown = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traffic.traced_window()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
        trace = harness.Trace(prof, window_s)
        metrics = {}
        for m in cell["per_layer"]:
            value = harness.metric_reader(m["name"]).read(traffic.context(trace))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown()
    else:
        values = traffic.window(args.seconds)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    loaded = harness.forbidden_modules()
    if loaded:
        raise harness.HarnessError(f"modules of JAX or its package were loaded: {loaded}")
    if device.type == "cuda":
        dev = harness.device_info(torch, cell["chips"])
        if args.trace:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    attempted, failed = traffic.attempted, traffic.failed
    traffic.release()
    checks = traffic.check()
    correct = harness.checks_ok(checks) and failed == 0
    for c in checks:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return correct, harness.result_line(correct, attempted, failed, metrics, dev, checks,
                                        breakdown)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        _, line = run(args)
    except harness.HarnessError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
