"""Port models against the JAX package on the CPU: the same weights (JAX
init → numpy, BN statistics randomized → ``convert.py``) and the same
inputs through both, for the encoder, a 3D block, every ``MultiDimStacker``
split method and the BN fold.

Tolerance (float32): max|Δ| ≤ 1e-4·max|ref|, which allows for another order
of the sums inside the convolutions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.models.blocks3d import (
    InvertedResidual3d as JaxInvertedResidual3d,
)
from ball_action_spotting_tpu.models.effnetv2 import (
    EfficientNetV2Features as JaxEfficientNetV2Features,
)
from ball_action_spotting_tpu.models.fold_bn import fold_bn_variables
from ball_action_spotting_torch.convert import (
    flax_tree_to_state_dict,
    jax_variables_to_state_dict,
)
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.blocks3d import InvertedResidual3d
from ball_action_spotting_torch.models.effnetv2 import (
    EFFNETV2_ARCHS,
    BlockDef,
    EfficientNetV2Features,
    resolve_arch,
    same_pad,
)
from ball_action_spotting_torch.models.fold_bn import fold_bn_state_dict
from tests.tiny_arch import register_tiny_arch

RTOL = 1e-4


def register_port_tiny_arch() -> str:
    """The port's copy of ``tests/tiny_arch.py``: ``efficientnetv2_test``
    in the port's own arch table."""
    EFFNETV2_ARCHS["efficientnetv2_test"] = (
        8,
        (
            BlockDef("cn", 1, 3, 1, 1, 8),
            BlockDef("er", 1, 3, 2, 2, 8),
            BlockDef("er", 1, 3, 2, 2, 16),
            BlockDef("ir", 1, 3, 2, 2, 16, 0.25),
            BlockDef("ir", 1, 3, 2, 2, 24, 0.25),
        ),
        1.0,
        1.0,
    )
    return "efficientnetv2_test"


register_tiny_arch()
register_port_tiny_arch()

NN_KWARGS = dict(
    model_name="efficientnetv2_test", num_classes=2, num_frames=6, stack_size=3,
    index_2d_features=4, num_3d_blocks=2, num_3d_features=16, num_3d_stack_proj=16,
    expansion_3d_ratio=2, se_reduce_3d_ratio=4, drop_rate=0.0, drop_path_rate=0.0,
)


def assert_close(actual, expected, rtol=RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    assert np.abs(actual - expected).max() <= rtol * np.abs(expected).max()


def to_numpy_tree(variables, seed: int = 0):
    """JAX variables as numpy, with every BN's scale, bias, mean and var
    randomized (a fresh init has the identity BN, which would hide a wrong
    eps or a wrong fold)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), variables)

    def walk(params, stats):
        for key, value in params.items():
            if key == "BatchNorm_0":
                c = value["scale"].shape[0]
                value["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                value["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
                stats[key]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(value, dict):
                walk(value, stats.get(key, {}))

    walk(tree["params"], tree.get("batch_stats", {}))
    return tree


def port_model(tree, **kwargs):
    kwargs = {**NN_KWARGS, **kwargs}
    model = build_model("multidim_stacker", bn_folded="batch_stats" not in tree, **kwargs)
    model.load_state_dict(jax_variables_to_state_dict(tree, NN_KWARGS))
    return model.eval()


@pytest.fixture(scope="module")
def stacker():
    """(JAX model, numpy variables, frames, JAX forward_2d features, JAX
    forward_3d map) for the tiny stacker."""
    model = jax_build_model("multidim_stacker", **NN_KWARGS)
    x = np.random.default_rng(0).random((2, 6, 64, 96)).astype(np.float32)
    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    tree = to_numpy_tree(variables)
    feats = np.asarray(model.apply(tree, jnp.asarray(x), train=False,
                                   method=type(model).forward_2d))
    fused = np.asarray(model.apply(tree, jnp.asarray(feats), train=False,
                                   method=type(model).forward_3d))
    return model, tree, x, feats, fused


def test_resolve_arch_and_same_pad():
    stem, stages = resolve_arch("tf_efficientnetv2_b0.in1k")
    assert stem == 32 and [s.channels for s in stages] == [16, 32, 48, 96, 112, 192]
    assert EfficientNetV2Features.feature_channels("efficientnetv2_b0", 4) == 192
    # TF SAME: the extra pixel of a stride-2 conv goes bottom/right
    assert same_pad(736, 3, 2) == (0, 1) and same_pad(23, 3, 1) == (1, 1)


def test_effnetv2_features_matches_jax():
    enc = JaxEfficientNetV2Features(model_name="efficientnetv2_test", in_chans=3)
    x = np.random.default_rng(1).random((2, 37, 50, 3)).astype(np.float32)  # odd sizes
    variables = enc.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
    tree = to_numpy_tree(variables, seed=1)
    expected = enc.apply(tree, jnp.asarray(x), train=False)

    port = EfficientNetV2Features("efficientnetv2_test", in_chans=3)
    port.load_state_dict(flax_tree_to_state_dict(tree))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close(out.permute(0, 2, 3, 1).numpy(), expected)


def test_inverted_residual3d_matches_jax():
    block = JaxInvertedResidual3d(16, expansion_ratio=3, se_reduce_ratio=4)
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 6, 16)).astype(np.float32)
    variables = block.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x))
    tree = to_numpy_tree(variables, seed=2)
    expected = block.apply(tree, jnp.asarray(x), train=False)
    # SE width is mid // ratio of the expanded width: 48 // 4
    assert tree["params"]["se"]["conv_reduce"]["kernel"].shape[-1] == 12

    for use_kernel in (False, True):
        port = InvertedResidual3d(16, expansion_ratio=3, se_reduce_ratio=4,
                                  dw_use_kernel=use_kernel)
        port.load_state_dict(flax_tree_to_state_dict(tree))
        with torch.no_grad():
            out = port.eval()(torch.from_numpy(x))
        assert_close(out.numpy(), expected)


@pytest.mark.parametrize("method", [
    "forward_2d", "forward_2d_nhwc", "forward_3d", "forward_head",
    "forward_3d_head", "__call__",
])
def test_multidim_stacker_split_methods_match_jax(stacker, method):
    model, tree, frames, feats, fused = stacker
    port = port_model(tree)
    inputs = {
        "forward_2d": frames,
        "forward_2d_nhwc": frames.reshape(4, 3, 64, 96).transpose(0, 2, 3, 1),
        "forward_3d": feats,
        "forward_head": fused,
        "forward_3d_head": feats,
        "__call__": frames,
    }[method]
    expected = model.apply(tree, jnp.asarray(inputs), train=False,
                           method=None if method == "__call__" else getattr(type(model), method))
    with torch.no_grad():
        fn = port if method == "__call__" else getattr(port, method)
        out = fn(torch.from_numpy(np.array(inputs)))
    assert_close(out.numpy(), expected)


def test_split_paths_agree(stacker):
    """forward_3d_head == forward_head ∘ forward_3d (the classifier order of
    the per-stack pool), and forward_2d_nhwc == forward_2d."""
    _, tree, frames, _, _ = stacker
    port = port_model(tree)
    x = torch.from_numpy(frames)
    with torch.no_grad():
        feats = port.forward_2d(x)
        nhwc = port.forward_2d_nhwc(x.reshape(4, 3, 64, 96).permute(0, 2, 3, 1))
        assert_close(nhwc.numpy(), feats.reshape(nhwc.shape).numpy())
        assert_close(port.forward_3d_head(feats).numpy(),
                     port.forward_head(port.forward_3d(feats)).numpy())


def test_fold_bn_matches_jax_fold_and_unfolded(stacker):
    _, tree, frames, _, _ = stacker
    port_folded = fold_bn_state_dict(jax_variables_to_state_dict(tree, NN_KWARGS))
    jax_folded = jax.tree.map(np.asarray, fold_bn_variables(tree))
    expected_sd = jax_variables_to_state_dict(jax_folded, NN_KWARGS)
    assert sorted(port_folded) == sorted(expected_sd)
    for key, value in expected_sd.items():
        assert_close(port_folded[key].numpy(), value.numpy())

    folded = build_model("multidim_stacker", bn_folded=True, **NN_KWARGS)
    folded.load_state_dict(port_folded)
    x = torch.from_numpy(frames)
    with torch.no_grad():
        assert_close(folded.eval()(x).numpy(), port_model(tree)(x).numpy())
    jax_out = jax_build_model("multidim_stacker", bn_folded=True, **NN_KWARGS).apply(
        jax_folded, jnp.asarray(frames), train=False)
    with torch.no_grad():
        assert_close(folded(x).numpy(), jax_out)


def test_bn_eps_follow_the_jax_modules():
    from ball_action_spotting_tpu.models.blocks3d import InvertedResidual3d as J3d
    from ball_action_spotting_tpu.models.multidim_stacker import (
        PROJECTION_BN_EPS as JAX_PROJ_EPS,
    )
    from ball_action_spotting_torch.models.multidim_stacker import PROJECTION_BN_EPS

    assert EfficientNetV2Features.bn_eps == JaxEfficientNetV2Features.bn_eps == 1e-3
    assert InvertedResidual3d.bn_eps == J3d.bn_eps == 1e-5
    assert PROJECTION_BN_EPS == JAX_PROJ_EPS == 1e-5


def test_training_mode_is_refused(stacker):
    """Only the BN-folded model refuses training mode (as the JAX folded BN
    does); the unfolded one trains (``tests/test_torch_train.py``)."""
    _, tree, frames, _, _ = stacker
    folded = build_model("multidim_stacker", bn_folded=True, **NN_KWARGS)
    folded.load_state_dict(fold_bn_state_dict(jax_variables_to_state_dict(tree, NN_KWARGS)))
    with pytest.raises(ValueError, match="inference-only"):
        folded.train()(torch.from_numpy(frames))
    assert port_model(tree).train()(torch.from_numpy(frames)).shape == (2, 2)
