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
print(" ".join(names))
print(len(names))
"""


NEW_MODULES = ("predict.fused", "predict.export", "predict.host_loop", "parallel.mesh",
               "parallel.multihost", "cli.export_model", "models.torch_import",
               "models.pretrained", "models.multichan_stacker", "models.classifier2d")


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
