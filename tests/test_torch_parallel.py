"""The port's parallel modules on the CPU: the grid and batch arithmetic
against the JAX package's ``parallel/`` functions; the chunked engine on a
2×1 grid against one device; the ``torch.library`` registration of the
three kernels (``opcheck``); and data-parallel training in two gloo
processes against one process on the global batch, which is itself held to
the JAX train step.

Tolerances: the 2×1 grid against one device atol 1e-6 (float32, the same
ops on each row). Two-process steps against the one-process step: losses
rtol 1e-5, parameters within 1e-5·max|ref| over all parameters (the global
BN statistics and the averaged gradients sum in another order, and Adam
scales the rounding noise of the zero gradient of a BN bias followed by
another batch-statistic BN up to ~1e-7), the two ranks' parameters bitwise
equal. The one-process step against JAX: as
``tests/test_torch_train.py``, loss rtol 1e-5 and parameters atol 2e-5
after AdamW."""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.ops.focal_loss import FocalLoss as JaxFocalLoss
from ball_action_spotting_tpu.parallel import multihost as jax_multihost
from ball_action_spotting_tpu.parallel.mesh import pad_batch_to_devices as jax_pad_batch
from ball_action_spotting_tpu.train.optim import build_optimizer as jax_build_optimizer
from ball_action_spotting_tpu.train.state import TrainState as JaxTrainState
from ball_action_spotting_tpu.train.steps import make_train_step as jax_make_train_step
from ball_action_spotting_torch.convert import (
    flax_tree_to_state_dict,
    state_dict_to_flax_tree,
)
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.ops.augment import apply_augment, sample_augment_params
from ball_action_spotting_torch.ops.dwconv3d import dwconv3d_op
from ball_action_spotting_torch.ops.gem import gem_pool_op, gem_pool_partial_op
from ball_action_spotting_torch.ops.warp import warp_resample_op
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import make_mesh, pad_batch_to_devices
from ball_action_spotting_torch.predict.pipeline import device_grid
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    iter_source_frames,
)
from ball_action_spotting_torch.train.steps import normalize_frames, step_generators
from tests import torch_dp_worker as worker
from tests.test_torch_fused import make_ckpt

ROOT = Path(__file__).resolve().parents[1]
FRAME_COUNT = 40
SRC_KWARGS = dict(num_frames=FRAME_COUNT, height=64, width=96, seed=1, events={20: 0, 30: 1})


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny arch gains nothing from intra-op threads, and beside the
    suite's other workers they oversubscribe the cores (as
    ``tests/test_torch_chain.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,count", [(0, 2), (1, 2), (7, 2), (8, 4), (10, 3), (13, 8)])
def test_batch_arithmetic_matches_jax(n, count):
    frames = np.arange(max(n, 1) * 2).reshape(max(n, 1), 2)[:n]
    targets = frames[:, :1] * 10
    if n:
        got = pad_batch_to_devices(frames, targets, count)
        expected = jax_pad_batch(frames, targets, count)
        for a, b in zip(got, expected):
            np.testing.assert_array_equal(a, b)
    for index in range(count):
        assert multihost.process_slice(n, index, count) == \
            jax_multihost.process_slice(n, index, count)
        assert multihost.process_slice_even(n, index, count) == \
            jax_multihost.process_slice_even(n, index, count)
    if n % count:
        with pytest.raises(ValueError, match="not divisible"):
            multihost.local_batch_size(n, count)
        with pytest.raises(ValueError, match="not divisible"):
            jax_multihost.local_batch_size(n, count)
    else:
        assert multihost.local_batch_size(n, count) == jax_multihost.local_batch_size(n, count)


@pytest.mark.parametrize("n,world", [(13, 2), (16, 4), (9, 4), (3, 2)])
def test_batch_shard_concatenates_to_the_global_batches(n, world):
    """Each process's local batches, concatenated in process order, are the
    one-process global batches of 4 rows; a trailing batch of fewer rows
    than processes is dropped, so every process makes the same steps."""
    class Rows:
        def __len__(self):
            return n

    shards = [multihost.BatchShard(Rows(), 4, r, world) for r in range(world)]
    local = 4 // world
    steps = {-(-len(s) // local) for s in shards}
    assert len(steps) == 1
    got = []
    for k in range(steps.pop()):
        for s in shards:
            got.extend(s.global_index(i) for i in range(k * local, min((k + 1) * local, len(s))))
    trailing = n % 4
    kept = n - trailing + (trailing if trailing >= world else 0)
    assert got == list(range(kept))


def test_make_mesh_grid():
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.data_devices() == [torch.device("cpu")] * 2
    assert make_mesh(1, 2, ["cpu"] * 2).model_devices() == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(2, 2, ["cpu"] * 3)


def test_device_grid_starts_at_the_requested_card(monkeypatch):
    """``--data_parallel``/``--fold_parallel`` with ``--device cuda:K`` lay
    the grid over cards K, K+1, ...; a grid past the last card raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert device_grid(2, 1, "cuda:2").data_devices() == cards[2:4]
    assert device_grid(1, 2, "cuda").model_devices() == cards[1:3]
    assert device_grid(2, 1, "cpu").data_devices() == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="4 are visible"):
        device_grid(1, 2, "cuda:3")


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("par") / "model-001-0.500000.ckpt")


@pytest.mark.parametrize("carry_features,tta,chunk", [(True, False, 10), (False, False, 10),
                                                     (True, True, 7)])
def test_chunked_engine_on_a_data_grid_matches_one_device(ckpt_path, carry_features, tta,
                                                          chunk):
    """Each of two grid devices predicts its share of a chunk (7 windows
    split 4 + 3 included); the predictions equal one device's."""
    kw = dict(tta=tta, chunk_size=chunk, carry_features=carry_features, dtype=torch.float32)
    one = ChunkedVideoPredictor(ckpt_path, device="cpu", **kw)
    grid = ChunkedVideoPredictor(ckpt_path, mesh=make_mesh(2, 1, ["cpu", "cpu"]), **kw)
    i1, r1 = one.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    i2, r2 = grid.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    assert i1 == i2 and r2.shape == (28, 2)
    np.testing.assert_allclose(r2, r1, atol=1e-6)


@pytest.mark.parametrize("op", ["gem_pool", "gem_pool_partial", "dwconv3d", "warp_h", "warp_v"])
def test_opcheck_custom_ops(op):
    """``torch.library.opcheck`` on the CPU: schema, fake (shape) function,
    autograd registration (GeM's backwards) and tracing."""
    g = torch.Generator().manual_seed(0)
    if op.startswith("gem_pool"):
        args = (torch.rand(2, 3, 4, 8, generator=g, requires_grad=True),
                torch.full((1,), 3.0, requires_grad=True), 1e-6)
        fn = gem_pool_op if op == "gem_pool" else gem_pool_partial_op
    elif op == "dwconv3d":
        args = (torch.rand(1, 3, 4, 5, 6, generator=g), torch.rand(3, 3, 3, 1, 6, generator=g))
        fn = dwconv3d_op
    else:
        img = torch.rand(2, 5, 8, generator=g)
        length = 5 if op == "warp_h" else 8
        args = (img, 1.0 + 0.1 * torch.rand(2, generator=g),
                torch.rand(2, length, generator=g), 4, "highest", 2 if op == "warp_h" else 1)
        fn = warp_resample_op
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(mode: str, out_dir: Path, world: int = 2) -> list:
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dp_worker", mode, str(r),
                               str(world), str(port), str(out_dir)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outs.append(out)
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    return [torch.load(out_dir / f"{mode}_{r}.pt", weights_only=False) for r in range(world)]


def test_two_process_steps_equal_one_process_on_the_global_batch(tmp_path):
    ranks = run_workers("step", tmp_path)
    ref = worker.step_run()
    for got in ranks:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    scale = max(v.abs().max().item() for v in ref["params"].values())
    for name, value in ref["params"].items():
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
        err = (ranks[0]["params"][name] - value).abs().max().item()
        assert err <= 1e-5 * scale, (name, err)


def test_one_process_augmented_step_matches_jax():
    """The one-process step that the two processes are held to, with its
    augmentation and mixup, against the JAX step given the same prepared
    batch (drop rates 0: the two packages draw masks from different
    generators)."""
    ref = worker.step_run(drop=False)
    tree = state_dict_to_flax_tree(_initial_params(), _model())
    model = jax_build_model("multidim_stacker", **dict(worker.NN_KWARGS, drop_rate=0.0,
                                                       drop_path_rate=0.0))
    tx = jax_build_optimizer("AdamW", {"eps": worker.ADAM_EPS}, schedule=1e-3)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    # the JAX step takes the prepared batch as its frames, scaled back by
    # 255 (its normalize divides by 255 again: ~1 ulp), with neither
    # augmentation nor mixup of its own
    jstep = jax.jit(jax_make_train_step(model, JaxFocalLoss(alpha=-1.0, gamma=1.2), tx,
                                        ema_decay=0.9))
    losses = []
    for k, (frames, targets) in enumerate(worker.global_batches()):
        x, t = _prepared(frames, targets, k)
        jstate, aux = jstep(jstate, jnp.asarray(x * 255.0), jnp.asarray(t),
                            jax.random.PRNGKey(0))
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-5)
    expected = flax_tree_to_state_dict({"params": jax.tree.map(np.asarray, jstate.params),
                                        "batch_stats": jax.tree.map(np.asarray,
                                                                    jstate.batch_stats)})
    assert sorted(expected) == sorted(ref["params"])
    for name, value in ref["params"].items():
        np.testing.assert_allclose(value.numpy(), np.asarray(expected[name]), atol=2e-5,
                                   err_msg=name)


def _model():
    from ball_action_spotting_torch.models import build_model, init_train_weights

    model = build_model("multidim_stacker", **dict(worker.NN_KWARGS, drop_rate=0.0,
                                                   drop_path_rate=0.0))
    init_train_weights(model, torch.Generator().manual_seed(5))
    return model


def _initial_params():
    return _model().state_dict()


def _prepared(frames, targets, step):
    """The step's augmented and mixed batch, drawn as ``make_train_step``
    draws it for step ``step`` of seed 7."""
    host_gen, dev_gen = step_generators(7, step, torch.device("cpu"))
    x = normalize_frames(torch.from_numpy(frames))
    b, t, h, w = x.shape
    x = apply_augment(x, sample_augment_params(host_gen, dev_gen, b, t, h, w, worker.AUG),
                      worker.AUG)
    x, tgt = worker.MIXUP.apply(x, torch.from_numpy(targets),
                                worker.MIXUP.sample(host_gen, h, w))
    return x.numpy(), tgt.numpy()


def test_two_process_fit_writes_once_and_agrees(tmp_path):
    """``Trainer.fit`` over ``BatchShard`` loaders: only rank 0 writes its
    logs and checkpoints; both ranks' validation metrics are equal, and
    equal the same weights' metrics over the whole set in one process (the
    trailing batch's padding rows dropped)."""
    ranks = run_workers("fit", tmp_path)
    assert ranks[0]["val_len"] % worker.GLOBAL_BATCH  # a trailing batch is padded
    assert ranks[0]["steps"] == ranks[1]["steps"] == 4
    for key, value in ranks[0]["final"].items():
        assert ranks[1]["final"][key] == value, key
    for key, value in ranks[0]["whole"].items():
        np.testing.assert_allclose(ranks[0]["final"][key], value, rtol=1e-6, err_msg=key)
    primary, other = tmp_path / "rank_0", tmp_path / "rank_1"
    assert (primary / "log.txt").exists() and (primary / "log.csv").exists()
    assert list(primary.glob("*.ckpt"))
    assert not (other / "log.txt").exists() and not (other / "log.csv").exists()
    assert not list(other.glob("*.ckpt"))


def test_unequal_batch_counts_raise_on_every_rank(tmp_path):
    ranks = run_workers("unequal", tmp_path)
    for got in ranks:
        assert got["error"] is not None and "unequal per-process batch counts [2, 3]" in \
            got["error"]
