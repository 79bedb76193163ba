"""Port training against the JAX package on the CPU, float32, tiny arch at
64×96, drop rates 0, no augmentation: the training-mode forward and its
BN running statistics; one train step's loss and gradients; the parameters,
BN statistics and EMA after two steps (AdamW, and SGD-Nesterov with the
frozen encoder); ``iter_size=2`` against JAX's scan; the learning-rate
schedule; drop path and dropout by their statistics; the epoch metrics.

Tolerances: forward and statistics max|Δ| ≤ 1e-4·max|ref| (other orders of
the convolutions' float32 sums, as ``test_torch_models.py``); losses rtol
1e-5; gradients 1e-4·max|ref| + 1e-7 per tensor (a BN bias followed by
another batch-statistic BN has a gradient that is 0 up to rounding, ~1e-8);
parameters after AdamW steps atol 2e-5; after SGD steps 1e-5·max|ref| +
1e-7; rates rtol 1e-6. The AdamW steps use eps = 1e-3: Adam divides each
gradient by its own magnitude, so at the default 1e-8 the rounding noise of
those zero gradients would move their parameters by ~lr in either
direction; eps = 1e-3 keeps that below the tolerance and still tells eps
outside the square root from eps inside it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.ops.focal_loss import FocalLoss as JaxFocalLoss
from ball_action_spotting_tpu.train.optim import build_optimizer as jax_build_optimizer
from ball_action_spotting_tpu.train.schedules import warmup_cosine as jax_warmup_cosine
from ball_action_spotting_tpu.train.state import TrainState as JaxTrainState
from ball_action_spotting_tpu.train.steps import make_train_step as jax_make_train_step
from ball_action_spotting_torch.convert import jax_variables_to_state_dict, state_dict_to_flax_tree
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.effnetv2 import (
    DropPath,
    Dropout,
    EfficientNetV2Features,
    set_dropout_generator,
)
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.train.metrics import Accuracy, AveragePrecision, average_precision
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.schedules import get_lr, warmup_cosine
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step
from tests.test_torch_models import NN_KWARGS, register_port_tiny_arch, to_numpy_tree

register_port_tiny_arch()
LR = 1e-3
EMA = 0.9
ADAM_EPS = 1e-3


def assert_close(actual, expected, rtol=1e-4, atol=0.0, what=""):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape, what
    err = np.abs(actual - expected).max() if actual.size else 0.0
    assert err <= rtol * np.abs(expected).max() + atol, (what, err)


def leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def assert_trees_close(port_tree, jax_tree, **kw):
    port, ref = dict(leaves(port_tree)), dict(leaves(jax.tree.map(np.asarray, jax_tree)))
    assert sorted(port) == sorted(ref)
    for name, value in ref.items():
        assert_close(port[name], value, what=name, **kw)


@pytest.fixture(scope="module")
def setup():
    """(JAX model, numpy variables with randomized BN, two batches)."""
    model = jax_build_model("multidim_stacker", **NN_KWARGS)
    x0 = jnp.zeros((1, 6, 64, 96), jnp.float32)
    tree = to_numpy_tree(model.init({"params": jax.random.PRNGKey(0)}, x0, train=False))
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (4, 6, 64, 96), dtype=np.uint8),
                (rng.random((4, 2)) > 0.5).astype(np.float32)) for _ in range(2)]
    return model, tree, batches


def port_model(tree):
    model = build_model("multidim_stacker", **NN_KWARGS)
    model.load_state_dict(jax_variables_to_state_dict(tree, NN_KWARGS))
    return model


def port_tree(model):
    return state_dict_to_flax_tree(model.state_dict(), model)


def test_train_mode_forward_and_bn_statistics_match_jax(setup):
    model, tree, batches = setup
    x = batches[0][0].astype(np.float32) / 255.0
    expected, mutated = model.apply(tree, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = port_model(tree).train()
    out = port(torch.from_numpy(x))
    assert_close(out.detach().numpy(), expected)
    assert_trees_close({"batch_stats": port_tree(port)["batch_stats"]}, dict(mutated))


@pytest.fixture(scope="module")
def adamw_runs(setup):
    """Two AdamW steps at a constant rate on both sides, plus the JAX
    gradients of the first step."""
    model, tree, batches = setup
    loss_fn = JaxFocalLoss(alpha=-1.0, gamma=1.2)
    tx = jax_build_optimizer("AdamW", {"eps": ADAM_EPS}, schedule=LR)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    jstep = jax.jit(jax_make_train_step(model, loss_fn, tx, ema_decay=EMA))

    def forward_loss(params, x, t):
        out, _ = model.apply({"params": params, "batch_stats": jstate.batch_stats}, x,
                             train=True, mutable=["batch_stats"])
        return loss_fn(out, t)

    x0 = jnp.asarray(batches[0][0]).astype(jnp.float32) / 255.0
    jgrads = jax.jit(jax.grad(forward_loss))(jstate.params, x0, jnp.asarray(batches[0][1]))
    jaux = []
    for frames, targets in batches:
        jstate, aux = jstep(jstate, jnp.asarray(frames), jnp.asarray(targets),
                            jax.random.PRNGKey(0))
        jaux.append(aux)

    pmodel = port_model(tree)
    pstate = TrainState(pmodel, build_optimizer("AdamW", {"eps": ADAM_EPS}, pmodel))
    pstep = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda c: LR, EMA)
    paux, pgrads = [], None
    for frames, targets in batches:
        paux.append(pstep(pstate, torch.from_numpy(frames), torch.from_numpy(targets), 0))
        if pgrads is None:
            pgrads = state_dict_to_flax_tree(
                {n: p.grad for n, p in pmodel.named_parameters()}, pmodel)
    return jstate, jaux, jgrads, pstate, paux, pgrads


def test_train_step_loss_and_gradients_match_jax(adamw_runs):
    _, jaux, jgrads, _, paux, pgrads = adamw_runs
    for j, p in zip(jaux, paux):
        np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), rtol=1e-5)
        assert_close(p["prediction"].numpy(), j["prediction"])
    assert_trees_close(pgrads, {"params": jgrads}, atol=1e-7)


def test_two_adamw_steps_match_jax_params_stats_and_ema(adamw_runs):
    jstate, _, _, pstate, _, _ = adamw_runs
    assert pstate.step == int(jstate.step) == 2
    raw, ema = port_tree(pstate.model), port_tree(pstate.ema)
    assert_trees_close({"params": raw["params"]}, {"params": jstate.params}, rtol=0.0, atol=2e-5)
    assert_trees_close({"batch_stats": raw["batch_stats"]}, {"batch_stats": jstate.batch_stats})
    assert_trees_close({"params": ema["params"]}, {"params": jstate.ema_params}, rtol=0.0, atol=2e-5)
    assert_trees_close({"batch_stats": ema["batch_stats"]},
                       {"batch_stats": jstate.ema_batch_stats})


def test_sgd_nesterov_with_frozen_encoder_matches_jax(setup):
    model, tree, batches = setup
    kwargs = {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}
    tx = jax_build_optimizer("SGD", kwargs, schedule=0.05, freeze_conv2d_encoder=True)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    jstep = jax.jit(jax_make_train_step(model, JaxFocalLoss(alpha=-1.0, gamma=1.2), tx,
                                        ema_decay=EMA))
    pmodel = port_model(tree)
    pstate = TrainState(pmodel, build_optimizer("SGD", kwargs, pmodel, freeze_conv2d_encoder=True))
    pstep = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda c: 0.05, EMA)
    for frames, targets in batches:
        jstate, _ = jstep(jstate, jnp.asarray(frames), jnp.asarray(targets), jax.random.PRNGKey(0))
        pstep(pstate, torch.from_numpy(frames), torch.from_numpy(targets), 0)
    raw = port_tree(pstate.model)
    assert_trees_close({"params": raw["params"]}, {"params": jstate.params}, rtol=1e-5, atol=1e-7)
    assert_trees_close({"batch_stats": raw["batch_stats"]}, {"batch_stats": jstate.batch_stats})
    # frozen: no update and no decay; the encoder's BN statistics still move
    np.testing.assert_array_equal(raw["params"]["conv2d_encoder"]["conv_stem"]["kernel"],
                                  tree["params"]["conv2d_encoder"]["conv_stem"]["kernel"])
    stats = raw["batch_stats"]["conv2d_encoder"]["bn1"]["BatchNorm_0"]["mean"]
    assert not np.allclose(stats, tree["batch_stats"]["conv2d_encoder"]["bn1"]["BatchNorm_0"]["mean"])


def test_iter_size_2_matches_jax_scan(setup):
    model, tree, batches = setup
    frames, targets = batches[0]
    tx = jax_build_optimizer("SGD", {"momentum": 0.0}, schedule=0.1)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    jstep = jax.jit(jax_make_train_step(model, JaxFocalLoss(alpha=-1.0, gamma=1.2), tx,
                                        ema_decay=EMA, iter_size=2))
    jstate, jaux = jstep(jstate, jnp.asarray(frames), jnp.asarray(targets), jax.random.PRNGKey(0))
    pmodel = port_model(tree)
    pstate = TrainState(pmodel, build_optimizer("SGD", {"momentum": 0.0}, pmodel))
    paux = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda c: 0.1, EMA, iter_size=2)(
        pstate, torch.from_numpy(frames), torch.from_numpy(targets), 0)
    np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]), rtol=1e-5)
    raw = port_tree(pstate.model)
    assert_trees_close({"params": raw["params"]}, {"params": jstate.params}, rtol=1e-5, atol=1e-7)
    # the BN statistics carry from the first microbatch into the second
    assert_trees_close({"batch_stats": raw["batch_stats"]}, {"batch_stats": jstate.batch_stats})


def test_schedule_matches_optax():
    lr, min_lr = get_lr(3e-4, 8), get_lr(3e-6, 8)
    for warmup in (0, 5):
        ref = jax_warmup_cosine(lr, min_lr, warmup, 20)
        port = warmup_cosine(lr, min_lr, warmup, 20)
        for count in range(30):
            np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, atol=1e-12)
    assert warmup_cosine(lr, min_lr, 5, 20)(0) == 0.0  # the first warmup step has rate 0


def test_drop_path_and_dropout_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 3)
    for module in (DropPath(0.3), Dropout(0.3)):
        module.generator = g
        out = module.train()(x)
        kept = out != 0
        if isinstance(module, DropPath):
            assert bool((kept.all(1) | (~kept).all(1)).all())  # whole samples
        assert abs(kept.float().mean().item() - 0.7) < 0.01
        np.testing.assert_allclose(out[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
        assert torch.equal(module.eval()(x), x)
    with pytest.raises(ValueError, match="generator"):
        DropPath(0.3).train()(x)


def test_drop_path_rates_follow_the_jax_modules():
    model = build_model("multidim_stacker", model_name="efficientnetv2_b0", num_3d_blocks=2,
                        drop_rate=0.2, drop_path_rate=0.2)
    enc = model.conv2d_encoder
    total = 21  # b0 blocks over every stage, also those past the tap
    rates = [getattr(enc, n).drop_path.rate for n in enc.block_names]
    np.testing.assert_allclose(rates, [0.2 * i / total for i in range(len(rates))])
    assert [model.conv3d_encoder_0.drop_path.rate, model.dropout.rate] == [0.2, 0.2]
    assert isinstance(enc, EfficientNetV2Features)
    set_dropout_generator(model, torch.Generator())
    assert all(m.generator is not None for m in model.modules()
               if isinstance(m, (DropPath, Dropout)))


def test_metrics_match_sklearn():
    from sklearn.metrics import average_precision_score

    rng = np.random.default_rng(0)
    scores = np.round(rng.random((50, 3)), 1)  # many ties
    targets = (rng.random((50, 3)) > 0.6).astype(np.float32)
    targets[:, 2] = 0.0  # a class absent from the split scores 0
    ap = AveragePrecision(["a", "b", "c"])
    acc = Accuracy(["a", "b", "c"], 0.5)
    for m in (ap, acc):
        m.update({"prediction": scores[:25], "target": targets[:25]})
        m.update({"prediction": scores[25:], "target": targets[25:]})
    expected = [average_precision_score(targets[:, c], scores[:, c]) for c in range(2)] + [0.0]
    np.testing.assert_allclose(ap.compute(), expected, rtol=1e-12)
    results = ap.results("val_")
    np.testing.assert_allclose(results["val_average_precision"], np.mean(expected))
    assert set(results) == {"val_average_precision", "val_average_precision_a",
                            "val_average_precision_b", "val_average_precision_c"}
    np.testing.assert_allclose(acc.compute(), ((scores > 0.5) == (targets > 0.5)).mean(0))
    assert average_precision(np.array([0.0, 0.0]), np.array([0.1, 0.2])) == 0.0
