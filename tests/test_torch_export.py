"""The port's sealed artifacts (``predict/export.py``) on the CPU: an
exported chunk program against the live engine and against the JAX
package's ``ExportedChunkPredictor`` on the same checkpoint (mirrors
``tests/test_export.py``).

The export seals the depthwise kernel's route, so the live engines here are
built with ``dw3d_use_kernel=True`` (the op's plain version on the CPU).

Tolerances: float32. Artifact against the live engine atol 1e-6 (the same
ops, traced); against JAX, and against the grouped conv's engine, atol
1e-5, as ``tests/test_torch_predict.py``."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.predict.export import (
    ExportedChunkPredictor as JaxExportedChunkPredictor,
    export_chunked_predictor as jax_export_chunked_predictor,
)
from ball_action_spotting_tpu.predict.streaming import (
    ChunkedVideoPredictor as JaxChunkedVideoPredictor,
    iter_source_frames as jax_iter_source_frames,
)
from ball_action_spotting_torch.cli.export_model import main as export_cli
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models.blocks3d import SqueezeExcite3d
from ball_action_spotting_torch.models.effnetv2 import BatchNormAct, SqueezeExcite2d
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.predict.export import (
    ExportedChunkPredictor,
    export_chunked_predictor,
)
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    iter_source_frames,
)
from tests.test_torch_fused import make_ckpt

ROOT = Path(__file__).resolve().parents[1]
FRAME_COUNT = 40
SRC_KWARGS = dict(num_frames=FRAME_COUNT, height=64, width=96, seed=1, events={20: 0, 30: 1})
F32 = dict(dtype=torch.float32, device="cpu", dw3d_use_kernel=True)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny arch gains nothing from intra-op threads, and beside the
    suite's other workers they oversubscribe the cores (as
    ``tests/test_torch_chain.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames():
    return iter_source_frames(SyntheticSource(**SRC_KWARGS))


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("export") / "model-001-0.500000.ckpt")


@pytest.fixture(scope="module")
def cli_artifact(ckpt_path, tmp_path_factory):
    """The export CLI's artifact of ``ckpt_path``, traced on the CPU (TTA
    off, chunk 8, float32)."""
    return export_cli(["--checkpoint", str(ckpt_path),
                       "--output", str(tmp_path_factory.mktemp("cli") / "cli.bastorx"),
                       "--chunk_size", "8", "--dtype", "float32", "--device", "cpu"])


@pytest.mark.parametrize("tta", [False, True])
def test_artifact_matches_live_engine_and_jax(ckpt_path, tmp_path, tta):
    live = ChunkedVideoPredictor(ckpt_path, tta=tta, chunk_size=8, **F32)
    art = export_chunked_predictor(live, tmp_path / "chunk.bastorx")
    sealed = ExportedChunkPredictor(art, device="cpu")
    assert (sealed.chunk_size, sealed.tta, sealed.num_classes, sealed.image_size) == \
        (8, tta, 2, (96, 64))
    assert sealed.meta["traced_device"] == "cpu" and sealed.num_folds is None
    idx_live, raw_live = live.predict_video(frames(), FRAME_COUNT)
    idx, raw = sealed.predict_video(frames(), FRAME_COUNT)
    assert idx == idx_live
    np.testing.assert_allclose(raw, raw_live, atol=1e-6)

    jax_live = JaxChunkedVideoPredictor(ckpt_path, tta=tta, dtype=jnp.float32, chunk_size=8)
    jax_art = jax_export_chunked_predictor(jax_live, tmp_path / "chunk.basx",
                                           platforms=("cpu",))
    j_idx, j_raw = JaxExportedChunkPredictor(jax_art).predict_video(
        jax_iter_source_frames(JaxSyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    assert list(j_idx) == idx
    np.testing.assert_allclose(raw, j_raw, atol=1e-5)


def test_artifact_short_video(cli_artifact):
    sealed = ExportedChunkPredictor(cli_artifact, device="cpu")
    idx, raw = sealed.predict_video(iter(()), 8)
    assert idx == [] and raw.shape == (0, 2)


def test_bad_artifact_and_mesh_predictor_rejected(ckpt_path, cli_artifact, tmp_path):
    bad = tmp_path / "bad.bastorx"
    bad.write_bytes(b"NOTMAGIC" + b"\0" * 32)
    with pytest.raises(ValueError, match="Not a bas-torch exported artifact"):
        ExportedChunkPredictor(bad, device="cpu")
    data = bytearray(cli_artifact.read_bytes())
    data[16:16 + len(b'{"format": 1')] = b'{"format": 9'
    wrong = tmp_path / "wrong_format.bastorx"
    wrong.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Unknown artifact format"):
        ExportedChunkPredictor(wrong, device="cpu")
    mesh = ChunkedVideoPredictor(ckpt_path, chunk_size=4, mesh=make_mesh(2, 1, ["cpu"] * 2),
                                 dtype=torch.float32, dw3d_use_kernel=True)
    with pytest.raises(ValueError, match="mesh-sharded"):
        export_chunked_predictor(mesh, tmp_path / "m.bastorx")


def test_export_cli_and_a_loader_without_model_code(ckpt_path, cli_artifact, tmp_path):
    """The CLI seals a checkpoint; a fresh process loads and runs the
    artifact without importing the port's model code."""
    out = cli_artifact
    live = ChunkedVideoPredictor(ckpt_path, chunk_size=8, **F32)
    _, raw_live = live.predict_video(frames(), FRAME_COUNT)
    np.save(tmp_path / "live.npy", raw_live)
    probe = f"""
import sys
import numpy as np
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.predict.export import ExportedChunkPredictor
from ball_action_spotting_torch.predict.host_loop import iter_source_frames
sealed = ExportedChunkPredictor({str(out)!r}, device="cpu")
idx, raw = sealed.predict_video(iter_source_frames(SyntheticSource(**{SRC_KWARGS!r})),
                                {FRAME_COUNT})
assert "ball_action_spotting_torch.models" not in sys.modules
assert not any(m.split(".")[0] in ("jax", "ball_action_spotting_tpu") for m in sys.modules)
np.testing.assert_allclose(raw, np.load({str(tmp_path / "live.npy")!r}), atol=1e-6)
print("ok", raw.shape)
"""
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok (28, 2)"


def test_fused_ensemble_sealed_whole(tmp_path):
    ckpts = [make_ckpt(tmp_path / f"model-00{i}-0.5.ckpt", seed=30 + i) for i in range(3)]
    fused = FusedFoldsPredictor(ckpts, chunk_size=10, **F32)
    l_idx, l_raw = fused.predict_video(frames(), FRAME_COUNT)
    sealed = ExportedChunkPredictor(export_chunked_predictor(fused, tmp_path / "ens.bastorx"),
                                    device="cpu")
    assert sealed.num_folds == 3
    e_idx, e_raw = sealed.predict_video(frames(), FRAME_COUNT)
    assert e_idx == l_idx and e_raw.shape == l_raw.shape == (28, 3, 2)
    np.testing.assert_allclose(e_raw, l_raw, atol=1e-6)
    idx, raw = sealed.predict_video(iter(()), 8)
    assert idx == [] and raw.shape == (0, 3, 2)


def test_exported_graph_holds_the_custom_ops(ckpt_path, cli_artifact, tmp_path):
    """The CLI's defaults seal the depthwise kernel's route whatever the
    device it traces on: a program traced on the CPU calls
    ``bas_torch::gem_pool`` once, ``bas_torch::dwconv3d`` once per 3D
    block, ``bas_torch::bias_act`` once per folded BN and
    ``bas_torch::se_scale`` once per SE module, so that on the card it
    launches the four kernels. A predictor on the grouped conv's route is
    refused."""
    sealed = ExportedChunkPredictor(cli_artifact, device="cpu")
    targets = [str(n.target) for n in sealed.program.graph.nodes if n.op == "call_function"]
    assert targets.count("bas_torch.gem_pool.default") == 1
    default = ChunkedVideoPredictor(ckpt_path, chunk_size=8, dtype=torch.float32, device="cpu")
    assert targets.count("bas_torch.dwconv3d.default") == default.model.num_3d_blocks
    assert targets.count("bas_torch.bias_act.default") == sum(
        isinstance(m, BatchNormAct) and m.folded for m in default.model.modules())
    assert targets.count("bas_torch.se_scale.default") == sum(
        isinstance(m, (SqueezeExcite2d, SqueezeExcite3d)) for m in default.model.modules()) > 0
    with pytest.raises(ValueError, match="dw3d_use_kernel=True"):
        export_chunked_predictor(default, tmp_path / "d.bastorx")
    _, raw_k = sealed.predict_video(frames(), FRAME_COUNT)
    _, raw_d = default.predict_video(frames(), FRAME_COUNT)  # grouped conv, chunk 8
    np.testing.assert_allclose(raw_k, raw_d, atol=1e-5)
