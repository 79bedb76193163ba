"""The port's pipeline parallelism (``parallel/pipeline.py``) on the CPU,
after ``tests/test_pipeline_parallel.py``: the 2-stage GPipe step against
the port's ``iter_size`` step it mirrors, on a data × pipeline grid, through
the ``Trainer``'s ``pipeline_parallel`` key with JAX's three refusals; and
the pipelined forward, loss and gradients against JAX's
``make_pp_forward_loss`` on a (1, 2) CPU mesh, with two train steps on each
side. The grids repeat the CPU device.

Tolerances (float32, drop rates 0): against JAX the loss rtol 2e-5, the
logits, gradients, parameters and EMA after two steps atol 2e-5, the BN
running statistics of the pipelined forward atol 1e-6 (the convolutions'
float32 sums run in another order) and after the two steps atol 2e-5 (they
are then computed by parameters that are themselves held at 2e-5); pp
against ``iter_size`` the same, as JAX's test holds its own. AdamW runs at
eps 1e-3, as ``tests/test_torch_train.py`` explains: at 1e-8 the rounding
noise of the zero gradients of a BN bias before another batch-statistic BN
would move those parameters by about the rate."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.ops.focal_loss import FocalLoss as JaxFocalLoss
from ball_action_spotting_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ball_action_spotting_tpu.parallel.mesh import replicate_state
from ball_action_spotting_tpu.parallel.pipeline import (
    make_pp_forward_loss as jax_make_pp_forward_loss,
    make_pp_train_step as jax_make_pp_train_step,
    pp_batch_sharding,
)
from ball_action_spotting_tpu.train.optim import build_optimizer as jax_build_optimizer
from ball_action_spotting_tpu.train.schedules import warmup_cosine as jax_warmup_cosine
from ball_action_spotting_tpu.train.state import TrainState as JaxTrainState
from ball_action_spotting_torch.convert import jax_variables_to_state_dict, state_dict_to_flax_tree
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.parallel.pipeline import (
    make_pp_forward_loss,
    make_pp_train_step,
    place_stages,
)
from ball_action_spotting_torch.train.checkpoint import save_checkpoint
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.schedules import warmup_cosine
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step
from tests.test_torch_models import NN_KWARGS, register_port_tiny_arch, to_numpy_tree
from tests.test_torch_train import assert_trees_close
from tests.test_train_engine import CLASSES, tiny_config

register_port_tiny_arch()
ATOL = 2e-5
LOSS_RTOL = 2e-5
STATS_ATOL = 1e-6
ADAM_EPS = 1e-3
EMA = 0.999
SCHEDULE = dict(base=3e-4, minimum=3e-6, warmup_steps=2, cosine_steps=8)
LOSS = dict(alpha=-1.0, gamma=1.2)


def cpu_grid(n_data, n_model):
    return make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))


def batch(b, h=64, w=96, seed=0):
    frames = np.random.default_rng(seed).integers(0, 255, (b, 6, h, w), dtype=np.uint8)
    targets = np.random.default_rng(seed + 1).random((b, 2)).astype(np.float32)
    return frames, targets


def schedule():
    s = SCHEDULE
    return warmup_cosine(s["base"], s["minimum"], s["warmup_steps"], s["cosine_steps"])


def port_state(model, placed_on=None):
    if placed_on is not None:
        place_stages(model, placed_on)
    return TrainState(model, build_optimizer("AdamW", {"eps": ADAM_EPS}, model))


@pytest.fixture(scope="module")
def port_model():
    """A tiny port model with randomized BN (from JAX's init)."""
    model = jax_build_model("multidim_stacker", **NN_KWARGS)
    tree = to_numpy_tree(model.init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 6, 64, 96)), train=False))
    port = build_model("multidim_stacker", **NN_KWARGS)
    port.load_state_dict(jax_variables_to_state_dict(tree, NN_KWARGS))
    return model, tree, port


def test_pp_forward_loss_and_two_steps_match_jax(port_model):
    model, tree, port = port_model
    frames, targets = batch(4)
    x = frames.astype(np.float32) / 255.0
    loss_fn = JaxFocalLoss(**LOSS)

    # JAX: the pipelined forward under value_and_grad on a (1, 2) CPU mesh
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    forward = jax_make_pp_forward_loss(model, loss_fn, mesh, n_micro=2)
    grad_fn = jax.jit(jax.value_and_grad(forward, has_aux=True))
    (jloss, (jlogits, jstats)), jgrads = grad_fn(
        tree["params"], tree["batch_stats"], jnp.asarray(x), jnp.asarray(targets),
        jax.random.PRNGKey(0))

    # the port: one backward over the pipelined graph
    pmodel = place_stages(copy.deepcopy(port).train(), cpu_grid(1, 2).model_devices(0))
    ploss, plogits = make_pp_forward_loss(FocalLoss(**LOSS), cpu_grid(1, 2), 2)(
        [pmodel], torch.from_numpy(x), torch.from_numpy(targets))
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(plogits.detach().numpy(), np.asarray(jlogits), atol=ATOL)
    pgrads = state_dict_to_flax_tree({n: p.grad for n, p in pmodel.named_parameters()}, pmodel)
    assert_trees_close({"params": pgrads["params"]}, {"params": jgrads}, rtol=0.0, atol=ATOL)
    assert_trees_close({"batch_stats": state_dict_to_flax_tree(
        pmodel.state_dict(), pmodel)["batch_stats"]}, {"batch_stats": jstats},
        rtol=0.0, atol=STATS_ATOL)

    # two pipelined train steps on each side: the warmup rate is 0 at step 0
    s = SCHEDULE
    tx = jax_build_optimizer("AdamW", {"eps": ADAM_EPS}, schedule=jax_warmup_cosine(
        s["base"], s["minimum"], warmup_steps=s["warmup_steps"], cosine_steps=s["cosine_steps"]))
    jstep = jax.jit(jax_make_pp_train_step(model, loss_fn, tx, EMA, mesh, n_micro=2))
    jstate = replicate_state(JaxTrainState.create(jax.tree.map(jnp.asarray, tree), tx), mesh)
    pstate = port_state(copy.deepcopy(port), cpu_grid(1, 2).model_devices(0))
    pstep = make_pp_train_step(FocalLoss(**LOSS), schedule(), EMA, cpu_grid(1, 2), 2)
    for k in range(2):
        frames, targets = batch(4, seed=10 + k)
        jstate, jaux = jstep(jstate, jax.device_put(frames, pp_batch_sharding(mesh)),
                             jax.device_put(targets, pp_batch_sharding(mesh)),
                             jax.random.PRNGKey(7))
        paux = pstep(pstate, torch.from_numpy(frames), torch.from_numpy(targets), 7)
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]), rtol=LOSS_RTOL)
    raw = state_dict_to_flax_tree(pstate.model.state_dict(), pstate.model)
    ema = state_dict_to_flax_tree(pstate.ema.state_dict(), pstate.ema)
    assert_trees_close({"params": raw["params"]}, {"params": jstate.params}, rtol=0.0, atol=ATOL)
    assert_trees_close({"params": ema["params"]}, {"params": jstate.ema_params},
                       rtol=0.0, atol=ATOL)
    assert_trees_close({"batch_stats": raw["batch_stats"]}, {"batch_stats": jstate.batch_stats},
                       rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("with_data_aug", [False, True])
def test_pp_step_matches_iter_size(port_model, n_micro, with_data_aug):
    """pp(n_micro=M) equals iter_size=M: with the augmentation and an
    always-on mixup, both draw per microbatch from the same generators, so
    mixup pairs rows within each microbatch alike. Two steps (the warmup
    rate is 0 at step 0), and the gradients of the second."""
    _, _, port = port_model
    kw = dict(augment=AugmentConfig(), mixup=Mixup(prob=1.0)) if with_data_aug else {}
    grid = cpu_grid(1, 2)
    pp_state = port_state(copy.deepcopy(port), grid.model_devices(0))
    ref_state = port_state(copy.deepcopy(port))
    pp_step = make_pp_train_step(FocalLoss(**LOSS), schedule(), EMA, grid, n_micro, **kw)
    ref_step = make_train_step(FocalLoss(**LOSS), schedule(), EMA, iter_size=n_micro, **kw)
    for k in range(2):
        frames, targets = (torch.from_numpy(a) for a in batch(4, seed=20 + k))
        aux_pp = pp_step(pp_state, frames, targets, 7)
        aux_ref = ref_step(ref_state, frames, targets, 7)
        np.testing.assert_allclose(float(aux_pp["loss"]), float(aux_ref["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(aux_pp["prediction"].numpy(), aux_ref["prediction"].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(aux_pp["target"].numpy(), aux_ref["target"].numpy(),
                                   atol=ATOL)
    pairs = [(pp_state.model.named_parameters(), ref_state.model.named_parameters(), ATOL),
             (pp_state.model.named_buffers(), ref_state.model.named_buffers(), STATS_ATOL),
             (pp_state.ema.named_parameters(), ref_state.ema.named_parameters(), ATOL)]
    for got, want, atol in pairs:
        for (name, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=atol,
                                       err_msg=name)
    for (name, a), (_, b) in zip(pp_state.model.named_parameters(),
                                 ref_state.model.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=ATOL, err_msg=name)


def test_pp_with_data_parallel_grid(port_model):
    """dp × pp: 2 data rows of 2 stages, each row its own split copy; every
    BN leaf moves (the warmup rate is 0 at step 0, so the parameters are not
    the signal): the encoder's on the rows' stage 0, the tail's on stage 1,
    merged into row 0."""
    _, _, port = port_model
    grid = cpu_grid(2, 2)
    state = port_state(copy.deepcopy(port), grid.model_devices(0))
    before = [b.clone() for b in state.model.buffers()]
    step = make_pp_train_step(FocalLoss(**LOSS), schedule(), EMA, grid, n_micro=2)
    frames, targets = (torch.from_numpy(a) for a in batch(8))
    aux = step(state, frames, targets, 3)
    assert np.isfinite(float(aux["loss"]))
    assert aux["prediction"].shape == (8, 2)
    assert state.step == 1
    for prev, now in zip(before, state.model.buffers()):
        assert float((now - prev).abs().max()) > 0


def pp_config(pp, **overrides):
    config = tiny_config(pipeline_parallel=pp, num_epochs=[1], stages=["train"], **overrides)
    return config


@pytest.mark.parametrize("pp", [2, {"n_micro": 2}])
def test_trainer_pipeline_parallel_config(pp, tmp_path):
    """``config["pipeline_parallel"]`` routes the Trainer's step through the
    GPipe step on a (2, 2) grid: a full batch and a trailing 6-row batch,
    padded to 8 (lcm(4 devices, 2 rows · 2 microbatches) = 4), train with
    finite losses; validation and prediction run on the split model."""
    trainer = Trainer(pp_config(pp), CLASSES, tmp_path / "pp", compute_dtype=torch.float32,
                      mesh=cpu_grid(2, 2))
    trainer.init_state()
    frames, targets = batch(8, h=64, w=96)
    metrics = trainer.train_epoch([(frames, targets), (frames[:6], targets[:6])], 0)
    assert np.isfinite(metrics["train_loss"])
    assert trainer.state.step == 2
    val = trainer.val_epoch([(frames[:6], targets[:6])], 0)
    assert np.isfinite(val["val_loss"])
    preds = trainer.predict_step(trainer.state, torch.from_numpy(frames).to(trainer.device))
    assert preds.shape == (8, 2) and bool(torch.isfinite(preds).all())


def test_pp_checkpoint_has_the_unsplit_layout(tmp_path):
    """A ``.ckpt`` written from the split model is byte for byte the one of
    the same weights in an unsplit model."""
    trainer = Trainer(pp_config(2), CLASSES, tmp_path / "pp", compute_dtype=torch.float32,
                      mesh=cpu_grid(1, 2))
    trainer.init_state()
    trainer.train_epoch([batch(8)], 0)
    split = tmp_path / "split.ckpt"
    save_checkpoint(split, trainer._params_dict(), trainer.variables(ema=True),
                    trainer.variables(ema=False))
    nn_name, nn_kwargs = trainer.config["argus_params"]["nn_module"]
    plain, plain_ema = (build_model(nn_name, **nn_kwargs) for _ in range(2))
    plain.load_state_dict(trainer.state.model.state_dict())
    plain_ema.load_state_dict(trainer.state.ema.state_dict())
    unsplit = tmp_path / "unsplit.ckpt"
    save_checkpoint(unsplit, trainer._params_dict(),
                    state_dict_to_flax_tree(plain_ema.state_dict(), plain_ema),
                    state_dict_to_flax_tree(plain.state_dict(), plain))
    assert Path(split).read_bytes() == Path(unsplit).read_bytes()


def test_trainer_pipeline_parallel_rejects_iter_size(tmp_path):
    config = pp_config(2)
    config["argus_params"]["iter_size"] = 2
    with pytest.raises(ValueError, match="iter_size"):
        Trainer(config, CLASSES, tmp_path / "x", compute_dtype=torch.float32,
                mesh=cpu_grid(2, 2))


def test_trainer_pipeline_parallel_rejects_indivisible_batch(tmp_path):
    """A batch_size that lcm(n_devices, data · n_micro) does not divide
    would pad every batch with duplicate rows: refused at config time."""
    with pytest.raises(ValueError, match="divisible"):  # batch 8 % lcm(4, 2·3) != 0
        Trainer(pp_config(3), CLASSES, tmp_path / "x", compute_dtype=torch.float32,
                mesh=cpu_grid(2, 2))


def test_trainer_pipeline_parallel_rejects_several_processes(tmp_path, monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="one process"):
        Trainer(pp_config(2), CLASSES, tmp_path / "x", compute_dtype=torch.float32,
                mesh=cpu_grid(2, 2))


def test_pp_rejects_wrong_stage_count(tmp_path):
    with pytest.raises(ValueError, match="model axis"):
        make_pp_train_step(FocalLoss(**LOSS), schedule(), EMA, cpu_grid(8, 1), n_micro=2)
    with pytest.raises(ValueError, match="model axis"):  # the Trainer's default grid
        Trainer(pp_config(2), CLASSES, tmp_path / "x", compute_dtype=torch.float32,
                device="cpu")
