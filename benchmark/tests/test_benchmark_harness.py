"""CPU tests of the benchmark's harness: names, the contract's form, every
traffic driver and metric reader on the tiny configuration, the command
without a card, the yardstick's counts, and the modules a run loads."""

from __future__ import annotations

import argparse
import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness
from benchmark import run as bench_run
from benchmark.reference.model import Reference
from benchmark.tests.tiny import CELLS, SPEC, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def run_tiny(cell, trace=0, hook=None, seed=2**31 + 9):
    args = argparse.Namespace(workload=cell["name"], seed=seed, seconds=0.5, trace=trace)
    correct, line = bench_run.run(args, device=torch.device("cpu"), cell=cell,
                                  t_start=time.perf_counter(), hook=hook)
    return correct, json.loads(line)


def test_contract_form():
    spec = BENCHMARK
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1].startswith("benchmark/")
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] + [
        m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert {w["config"] for w in spec["workloads"]} == {c["name"] for c in spec["configs"]}
    assert 2 + 14 * 24 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_name_is_found(name):
    cell = harness.find_cell(name, SPEC)
    assert hasattr(harness.traffic_module(cell["traffic"]), "Traffic")
    assert cell["model"]["name"] == cell["config"] and cell["model"]["reduced"] == []
    ends = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in ends and len(ends) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES) == (
            m["layer"], m["unit"], m["better"], m["moves"])


def test_configurations_match_the_program_recipes():
    """The configuration files state what the program's own recipe modules
    build, so the benchmark runs the model users run."""
    import importlib

    for c in BENCHMARK["configs"]:
        model = json.loads((ROOT / c["file"]).read_text())
        module = model["source_in_repo"].removesuffix(".py").replace("/", ".")
        port = importlib.import_module(module).config
        ap = port["argus_params"]
        name, kw = ap["nn_module"]
        kw = {k: v for k, v in kw.items() if k != "pretrained"}
        kw["model_name"] = kw["model_name"].replace("tf_", "").split(".")[0]
        assert (model["nn_module"], model["nn_module_kwargs"]) == (name, kw)
        for key in ("frame_stack_size", "frame_stack_step"):
            assert model[key] == ap[key], key
        assert list(model["image_size"]) == list(port["image_size"])


@pytest.mark.parametrize("name", CELLS)
def test_traffic_and_metrics_run_on_the_cpu(name):
    cell = tiny_cell(name)
    correct, line = run_tiny(cell)
    assert correct, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    correct, line = run_tiny(cell, trace=1)
    assert correct and "breakdown" in line
    # the host-clock readers read; the device-trace ones find no kernel on the CPU
    assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}


class FakeTrace(SimpleNamespace):
    def kernel_seconds(self, match):
        hits = [(s, n) for name, (s, n) in self.by_name.items() if match(name)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)


@pytest.mark.parametrize("name", sorted({m["name"] for m in SPEC["per_layer"]}))
def test_metric_readers_on_a_trace(name):
    """Every reader gives a number from a trace that holds its kernels, a
    share under 100 % where the device ran as fast as its bound."""
    cell = harness.find_cell(next(w for w in CELLS if name in [
        m["name"] for m in harness.find_cell(w, SPEC)["per_layer"]]), SPEC)
    kw = cell["model"]["nn_module_kwargs"]
    dw = counts.dwconv3d_bytes(256, 5, 23, 40, 576, "bfloat16")
    trace = FakeTrace(window_s=2.0, busy_s=1.5, by_name={
        "dwconv3d_kernel<bf16>": [8 * counts.bound_s(dw) * 2, 8],
        "void at::native::vectorized_elementwise_kernel<4>": [0.4, 100]})
    spans = SimpleNamespace(seconds={"bench.upload": [0.02, 0.04]})
    ctx = SimpleNamespace(trace=trace, spans=spans, cell=cell, frames=3000, chunks=8,
                          frame_flops=counts.predict_frame_flops(kw, 736, 1280, 2),
                          dwconv3d_bytes=dw)
    value = harness.metric_reader(name).read(ctx)
    assert value is not None and value > 0
    if name.split(".")[0].endswith(("roofline", "mfu", "share")):
        assert value <= 100.0
    if "roofline" in name:
        assert value == pytest.approx(50.0)


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          BENCHMARK["workloads"][0]["name"],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "CUDA" in out.stderr


def test_counts_match_hand_counts():
    ref = Reference({}, {"model_name": "efficientnetv2_b0"})
    x = torch.empty(2, 3, 736, 1280, device="meta")
    w = torch.empty(32, 3, 3, 3, device="meta")
    mode = FlopCounterMode(display=False)
    with mode:
        ref.conv2d(x, w, 2)
    assert mode.get_total_flops() == 2 * 2 * 32 * 3 * 9 * 368 * 640
    # the depthwise 3D conv's byte bound at a TTA chunk head's shape
    bound_ms = counts.bound_s(nbytes=counts.dwconv3d_bytes(256, 5, 23, 40, 576, "bfloat16")) * 1e3
    assert bound_ms == pytest.approx(0.810, abs=5e-4)


IMPORT_CHECK = r"""
import sys, time, argparse, json
sys.path.insert(0, {root!r})
import torch
from benchmark import run
from benchmark.tests.tiny import tiny_cell
for name in {cells!r}:
    cell = tiny_cell(name)
    args = argparse.Namespace(workload=name, seed=3, seconds=0.2, trace=0)
    run.run(args, device=torch.device("cpu"), cell=cell, t_start=time.perf_counter())
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "ball_action_spotting_tpu"))))
"""


def test_a_run_loads_nothing_of_jax():
    code = IMPORT_CHECK.format(root=str(ROOT), cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("ball_action_spotting_torch", "jax", "jaxlib",
                                               "flax", "ball_action_spotting_tpu"), (path, n)
