"""The port stands alone: importing every module of
``ball_action_spotting_torch`` and ``chip_smoke`` loads no JAX, no Flax and
nothing of ``ball_action_spotting_tpu`` (checked in a subprocess, since this
test process has JAX loaded by ``tests/conftest.py``); and its entry points
refuse to run without CUDA unless they are given ``device="cpu"``."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ball_action_spotting_torch.cli.dryrun_multichip import dryrun_multichip
from ball_action_spotting_torch.device import resolve_device
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.export import ExportedChunkPredictor
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.multistream import (
    DeviceStateMultiStreamPredictor,
    MultiStreamPredictor,
)
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    StreamingPredictor,
)
from ball_action_spotting_torch.train.engine import Trainer
from tests.test_train_engine import tiny_config

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ball_action_spotting_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import ball_action_spotting_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not loaded, loaded

# the gray store reads through the port's own library, never native/'s
import pathlib, tempfile
import numpy as np
from ball_action_spotting_torch.data.gray_store import GrayStore, write_gray_store
with tempfile.TemporaryDirectory() as d:
    path = pathlib.Path(d) / "v.gray"
    write_gray_store(path, [np.zeros((2, 3), np.uint8)], 2, 3, 1)
    GrayStore(path).read(0, 1)
maps = open("/proc/self/maps").read()
assert "/build/torch_kernels/libgray_store-" in maps
assert "/native/libgray_store" not in maps
print(" ".join(names))
print(len(names))
"""


NEW_MODULES = ("predict.fused", "predict.export", "predict.host_loop", "parallel.mesh",
               "parallel.multihost", "cli.export_model", "models.torch_import",
               "models.pretrained", "models.multichan_stacker", "models.classifier2d",
               "native", "data.gray_store", "utils.profiling", "cli.transcode",
               "cli.verify_data", "cli.rehearsal", "cli.visualize", "parallel.pipeline",
               "parallel.sharding_rules", "cli.dryrun_multichip", "models.quantize",
               "ops.int8_conv")


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 70  # every module was imported
    imported = out.stdout.strip().splitlines()[-2].split()
    for name in NEW_MODULES:
        assert f"ball_action_spotting_torch.{name}" in imported, name


def test_chip_smoke_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_need_cuda_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    for engine in (ChunkedVideoPredictor, StreamingPredictor, MultiStreamPredictor,
                   DeviceStateMultiStreamPredictor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(tmp_path / "model-001-0.5.ckpt")
    assert resolve_device("cpu") == torch.device("cpu")


def test_fused_export_and_grid_entry_points_need_cuda_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedFoldsPredictor([tmp_path / "model-001-0.5.ckpt"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExportedChunkPredictor(tmp_path / "chunk.bastorx")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1, 1)


def test_s2d_engines_and_new_families_need_cuda_or_cpu(tmp_path):
    """``s2d_stem`` and a reference ``.pth`` change nothing in the device
    rule; the new families build on the CPU and a Trainer of them still
    refuses a missing CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    for engine in (ChunkedVideoPredictor, StreamingPredictor, MultiStreamPredictor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(tmp_path / "model-001-0.5.pth", s2d_stem=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedFoldsPredictor([tmp_path / "model-001-0.5.pth"], s2d_stem=True)
    for name, kwargs in (("multichan_stacker", dict(num_chans=3)),
                         ("classifier2d", dict(pool="gem")), ("timm", {})):
        config = tiny_config()
        config["argus_params"]["nn_module"] = (name, dict(model_name="efficientnetv2_tiny",
                                                          num_classes=2, **kwargs))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(config, ["a", "b"], tmp_path / name)
        build_model(name, model_name="efficientnetv2_tiny", **kwargs).to("cpu")


def test_model_parallel_entry_points_need_cuda_or_cpu(tmp_path):
    """The pipeline-parallel Trainer and the dryrun take CUDA devices
    unless they are given the CPU, and never fall back to it."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_config(pipeline_parallel=2), ["a", "b"], tmp_path / "pp")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dryrun_multichip(1)


def test_int8_engines_need_cuda_or_cpu(tmp_path):
    """``conv_int8`` changes nothing in the device rule: every engine that
    takes it refuses a missing CUDA device unless it is given the CPU, and
    the int8 model builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    for engine in (ChunkedVideoPredictor, StreamingPredictor, MultiStreamPredictor,
                   DeviceStateMultiStreamPredictor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(tmp_path / "model-001-0.5.ckpt", conv_int8=True)
    build_model("multidim_stacker", model_name="efficientnetv2_tiny", conv2d_int8=True).to("cpu")
