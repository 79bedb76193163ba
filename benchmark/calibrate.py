"""Readings that the limits of ``correct`` are set from, for one cell, in
one process on the card (never run by the benchmark's own runs).

    python3 benchmark/calibrate.py --workload predict.b0_f15.tta \
        --seeds 11 12 ... --control-seeds 21 22 23 --fault-seeds 31 32 33 --out out.json

For each of ``--seeds`` the program's sound run (set-up, a window of
``--seconds``, the check); for each of ``--control-seeds`` the control
(the program with its int8 convolutions on); for each of
``--float32-seeds`` a witness (the program in float32 with TF32 off); for
each of ``--fault-seeds`` each fault of ``tests/faults.py`` that the
cell's traffic can have, planted under the timed path. Every compared
number, and what it was computed from, is written to ``--out`` as it
comes.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.tests.faults import FAULTS  # noqa: E402


def reading(cell, seed, seconds, kind, fault=None, device=None) -> dict:
    """One run's compared numbers: the program's (``kind`` "program"), the
    control's, the float32 witness's, or the program's with ``fault``
    planted."""
    device = device or torch.device("cuda", 0)
    module = harness.traffic_module(cell["traffic"])
    traffic = module.Traffic(cell, seed, device, traced=False)
    if kind == "control":
        traffic.program_options = {"conv_int8": True}
    if fault is not None:
        traffic.program_hook = FAULTS[cell["traffic"]][fault]
    if kind == "float32":
        traffic.model = dict(traffic.model, dtype="float32")
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        traffic.setup()
        traffic.window(seconds)
        traffic.release()
        checks = traffic.check()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    out = {"kind": kind, "fault": fault, "seed": seed, "seconds": time.perf_counter() - t0,
           "checks": {c["name"]: c["value"] for c in checks}, "detail": traffic.compared}
    del traffic
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--float32-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    cell = harness.find_cell(args.workload)
    jobs = [("program", s, None) for s in args.seeds]
    jobs += [("control", s, None) for s in args.control_seeds]
    jobs += [("float32", s, None) for s in args.float32_seeds]
    jobs += [("fault", s, f) for f in FAULTS[cell["traffic"]] for s in args.fault_seeds]
    with open(args.out, "a") as f:
        for kind, seed, fault in jobs:
            try:
                row = reading(cell, seed, args.seconds, kind, fault)
            except Exception as exc:  # a control or fault that crashes has failed
                row = {"kind": kind, "fault": fault, "seed": seed, "error": repr(exc)[:500]}
            row["workload"] = args.workload
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps({k: v for k, v in row.items() if k != "detail"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
