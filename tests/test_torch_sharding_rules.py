"""The port's tensor-parallel sharding rules (``parallel/sharding_rules.py``)
on the CPU, after ``tests/test_sharding_rules.py``: JAX's ``leaf_spec``
cases in the port's layout; the port's rule leaf for leaf against JAX's on
the Flax shapes, through ``convert.py``'s name map, for the flagship's
widths and the tiny arch's; ``shard_state``'s placement of the parameters,
EMA and moments; and a data-parallel step over a sharded state in two gloo
processes against the same step replicated (atol 2e-5; the gathered weights
are the replicated ones, so the two run the same arithmetic)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.parallel.mesh import MODEL_AXIS
from ball_action_spotting_tpu.parallel.sharding_rules import leaf_spec as jax_leaf_spec
from ball_action_spotting_torch.convert import flax_tree_to_state_dict
from ball_action_spotting_torch.models import build_model, init_train_weights
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.parallel.sharding_rules import (
    SHARDS,
    gathered,
    leaf_spec,
    shard_state,
)
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step
from tests import torch_dp_worker as worker
from tests.test_torch_models import NN_KWARGS, register_port_tiny_arch
from tests.test_torch_parallel import run_workers

register_port_tiny_arch()
ATOL = 2e-5
FLAGSHIP = dict(
    model_name="efficientnetv2_b0", num_classes=2, num_frames=15, stack_size=3,
    index_2d_features=4, num_3d_blocks=4, num_3d_features=192, expansion_3d_ratio=3,
    se_reduce_3d_ratio=24, num_3d_stack_proj=256, drop_rate=0.2, drop_path_rate=0.2)


def test_leaf_spec_rules():
    """JAX's cases, each shape in the port's layout: the output channels
    first (a (3, 3, 3, 512) HWIO kernel is (512, 3, 3, 3) OIHW)."""
    assert leaf_spec((512, 3, 3, 3), n_model=2) == 0
    assert leaf_spec((512,), n_model=2) is None  # vectors stay whole
    assert leaf_spec((100, 3, 3, 3), n_model=2) is None  # too small
    assert leaf_spec((257, 3, 3, 3), n_model=2) is None  # not divisible
    assert leaf_spec((384, 3, 3, 3), n_model=2) == 0
    assert leaf_spec((512, 3, 3, 3), n_model=1) is None
    assert leaf_spec((), n_model=2) is None
    for hwio in [(3, 3, 3, 512), (3, 3, 3, 100), (3, 3, 3, 257), (3, 3, 3, 384)]:
        oihw = (hwio[3], hwio[2], hwio[0], hwio[1])
        assert (leaf_spec(oihw, 2) == 0) == (jax_leaf_spec(hwio, 2) != P())


def flax_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flax_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def single_leaf_tree(path, shape):
    tree = node = {}
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.zeros(shape, np.float32)
    return tree


@pytest.mark.parametrize("kwargs,min_channels", [(FLAGSHIP, 256), (NN_KWARGS, 16),
                                                 (NN_KWARGS, 32)])
@pytest.mark.parametrize("n_model", [2, 4])
def test_port_rule_splits_the_leaves_jax_splits(kwargs, min_channels, n_model):
    """Every Flax leaf (shapes by ``jax.eval_shape``, no FLOPs) mapped to
    its port tensor by ``convert.py``: JAX splits its last dim exactly where
    the port splits dim 0, and that dim holds the same channels."""
    model = jax_build_model("multidim_stacker", **kwargs)
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, jnp.zeros((1, 15 if kwargs is
                                                  FLAGSHIP else 6, 64, 96)), train=False),
                            jax.random.PRNGKey(0))
    split = 0
    for path, leaf in flax_leaves(jax.tree.map(lambda s: s.shape, shapes,
                                               is_leaf=lambda s: hasattr(s, "shape"))):
        shape = tuple(leaf)
        (name, tensor), = flax_tree_to_state_dict(single_leaf_tree(path, shape)).items()
        jax_spec = jax_leaf_spec(shape, n_model, min_channels)
        port_dim = leaf_spec(tuple(tensor.shape), n_model, min_channels)
        if jax_spec == P():
            assert port_dim is None, name
        else:
            assert jax_spec == P(*([None] * (len(shape) - 1) + [MODEL_AXIS])), name
            assert port_dim == 0 and tensor.shape[0] == shape[-1], name
            split += 1
    assert split > 0


def tiny_state(seed=5):
    model = build_model("multidim_stacker", **NN_KWARGS)
    init_train_weights(model, torch.Generator().manual_seed(seed))
    return TrainState(model, build_optimizer("AdamW", {"eps": 1e-3}, model))


def test_shard_state_places_leaves():
    """Each split leaf becomes n_model slices of its output channels, in
    the model, the EMA and both AdamW moments (each slice its own step
    count); whole leaves stay; the gathered state_dict is the old one."""
    state = tiny_state()
    step = make_train_step(FocalLoss(), lambda c: 1e-3, 0.9)
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (2, 6, 64, 96),
                                                                 dtype=np.uint8))
    step(state, frames, torch.ones((2, 2)), 0)  # the moments exist
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {n: state.optimizer.state[p]["exp_avg"].clone()
               for n, p in state.model.named_parameters()}
    shard_state(state, make_mesh(1, 2, ["cpu"] * 2), min_channels=32, row=0)
    names = dict(state.model.named_parameters())
    split = [n for n in before if f"{n}{SHARDS}.0" in names]
    assert split, "min_channels=32 splits the 3D blocks' and the encoder's widest convs"
    for name in split:
        a, b = names[f"{name}{SHARDS}.0"], names[f"{name}{SHARDS}.1"]
        assert a.shape[0] == b.shape[0] == before[name].shape[0] // 2
        assert name not in names
        for k, shard in enumerate((a, b)):
            st = state.optimizer.state[shard]
            half = before[name].shape[0] // 2
            assert torch.equal(st["exp_avg"], moments[name][k * half:(k + 1) * half])
        assert state.optimizer.state[a]["step"] is not state.optimizer.state[b]["step"]
    ema_names = {n for n, _ in state.ema.named_parameters()}
    assert ema_names == set(names)
    whole = gathered(state.model.state_dict())
    assert set(whole) == set(before)
    for name, value in before.items():
        assert torch.equal(whole[name], value), name


def test_sharded_step_equals_replicated_step_in_one_process():
    """Two steps of a sharded state against the same state replicated."""
    steps = make_train_step(FocalLoss(), lambda c: 1e-3, 0.9)
    ref = tiny_state()
    tp = shard_state(copy.deepcopy(ref), make_mesh(1, 2, ["cpu"] * 2), min_channels=16, row=0)
    rng = np.random.default_rng(1)
    for _ in range(2):
        frames = torch.from_numpy(rng.integers(0, 255, (2, 6, 64, 96), dtype=np.uint8))
        targets = torch.from_numpy((rng.random((2, 2)) > 0.5).astype(np.float32))
        a = steps(tp, frames, targets, 3)
        b = steps(ref, frames, targets, 3)
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), atol=ATOL)
    for which in ("model", "ema"):
        got = gathered(getattr(tp, which).state_dict())
        for name, value in getattr(ref, which).state_dict().items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=ATOL, err_msg=name)


def test_sharded_step_equals_replicated_step_over_gloo(tmp_path):
    """(2, 2) grid: two gloo processes, one per row, each splitting its
    state over its row's two model-axis devices; three data-parallel steps
    equal the replicated ones, and both ranks hold the same weights."""
    ranks = run_workers("tp", tmp_path)
    for got in ranks:
        assert got["tp"]["shards"] > 0
        np.testing.assert_allclose(got["tp"]["losses"], got["replicated"]["losses"], atol=ATOL)
        for which in ("params", "ema"):
            for name, value in got["replicated"][which].items():
                np.testing.assert_allclose(got["tp"][which][name].numpy(), value.numpy(),
                                           atol=ATOL, err_msg=name)
    for name, value in ranks[0]["tp"]["params"].items():
        assert torch.equal(ranks[1]["tp"]["params"][name], value), name
    ref = worker.step_run(drop=False)  # one process on the global batch
    np.testing.assert_allclose(ranks[0]["tp"]["losses"], ref["losses"], rtol=1e-5)
