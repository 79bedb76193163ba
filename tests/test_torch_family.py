"""The port's model families beside ``multidim_stacker`` against the JAX
package on the CPU (tiny arch, float32, the same weights through
``convert.py``): the space-to-depth stem (against the standard stem and
against JAX's, at 3 input channels: ``F.pixel_unshuffle``'s channel order
agrees with JAX's only at 1), ``s2d_stem`` in the engines,
``multichan_stacker``, and ``classifier2d`` / ``timm`` (average and GeM
pooling, channels-last input, the BN fold of its ``encoder`` scope).

Tolerances: the s2d stem against the standard stem atol 1e-5 (as
``tests/test_s2d_stem.py``; another order of the stem's 27 products);
forwards against JAX max|Δ| ≤ 1e-4·max|ref| (as
``tests/test_torch_models.py``); the fold atol 1e-4 (as
``tests/test_fold_bn.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.models.effnetv2 import (
    EfficientNetV2Features as JaxEfficientNetV2Features,
)
from ball_action_spotting_tpu.models.effnetv2 import stem_kernel_to_s2d as jax_stem_kernel_to_s2d
from ball_action_spotting_tpu.predict.streaming import (
    StreamingPredictor as JaxStreamingPredictor,
    get_raw_predictions as jax_get_raw_predictions,
)
from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_torch.convert import flax_tree_to_state_dict
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.effnetv2 import (
    EfficientNetV2Features,
    space_to_depth,
    stem_kernel_to_s2d,
    stem_weight_to_s2d,
)
from ball_action_spotting_torch.models.fold_bn import default_eps_rule, fold_bn_state_dict
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    get_raw_predictions,
    iter_source_frames,
    StreamingPredictor,
)
from tests.test_torch_models import register_port_tiny_arch, to_numpy_tree
from tests.test_torch_predict import make_ckpt
from tests.test_torch_train import assert_close

register_port_tiny_arch()
ARCH = "efficientnetv2_test"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny arch gains nothing from intra-op threads, and beside the
    suite's other workers they oversubscribe the cores (as
    ``tests/test_torch_streaming.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomized(tree, seed: int = 0):
    """A JAX init tree as numpy, BN statistics randomized (so that the fold
    and the running statistics matter)."""
    return to_numpy_tree(tree, seed)


def jax_init(model, x, seed: int = 0, jit: bool = False):
    """Eager for the small models; jitted, the multi-channel stacker's 3D
    blocks take half the time of their eager ops."""
    init = lambda key, x: model.init({"params": key}, x, train=False)  # noqa: E731
    init = jax.jit(init) if jit else init
    return randomized(init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)


def jax_apply(model, tree, x, jit: bool = False):
    apply = lambda v, x: model.apply(v, x, train=False)  # noqa: E731
    return (jax.jit(apply) if jit else apply)(tree, jnp.asarray(x))


def test_s2d_channel_order_is_jax_and_not_pixel_unshuffle():
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    ours = space_to_depth(x)
    nhwc = x.permute(0, 2, 3, 1).numpy()
    b, h, w, c = nhwc.shape
    ref = nhwc.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    ref = ref.reshape(b, h // 2, w // 2, 4 * c).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert not torch.equal(F.pixel_unshuffle(x, 2), ours)  # (c, dy, dx) order
    assert torch.equal(F.pixel_unshuffle(x[:, :1], 2), space_to_depth(x[:, :1]))
    with pytest.raises(ValueError, match="even height and width"):
        space_to_depth(x[:, :, :3])


def test_stem_kernel_to_s2d_is_jax():
    k = np.random.default_rng(0).normal(size=(3, 3, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(stem_kernel_to_s2d(k), jax_stem_kernel_to_s2d(k))


def test_s2d_stem_matches_standard_stem_and_jax():
    """The s2d encoder with ``stem_weight_to_s2d`` of a standard stem gives
    the standard encoder's features; the same tree through JAX's s2d
    encoder gives the same."""
    x = np.random.default_rng(0).random((2, 3, 64, 96)).astype(np.float32)
    x_nhwc = x.transpose(0, 2, 3, 1)
    jax_std = JaxEfficientNetV2Features(model_name=ARCH, out_index=4)
    tree = jax_init(jax_std, x_nhwc)
    state = flax_tree_to_state_dict(tree)
    std = EfficientNetV2Features(ARCH, 4, in_chans=3).eval()
    std.load_state_dict(state)
    s2d = EfficientNetV2Features(ARCH, 4, in_chans=3, stem_space_to_depth=True).eval()
    s2d.load_state_dict({**state,
                         "conv_stem.weight": stem_weight_to_s2d(state["conv_stem.weight"])})
    with torch.no_grad():
        out_std = std(torch.from_numpy(x))
        out_s2d = s2d(torch.from_numpy(x))
    np.testing.assert_allclose(out_s2d.numpy(), out_std.numpy(), atol=1e-5, rtol=1e-4)

    jax_s2d = JaxEfficientNetV2Features(model_name=ARCH, out_index=4, stem_space_to_depth=True)
    params = dict(tree["params"])
    params["conv_stem"] = {"kernel": jax_stem_kernel_to_s2d(params["conv_stem"]["kernel"])}
    expected = jax_s2d.apply({"params": params, "batch_stats": tree["batch_stats"]},
                             jnp.asarray(x_nhwc))
    assert_close(out_s2d.numpy().transpose(0, 2, 3, 1), expected)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("ckpt") / "model-001-0.500000.ckpt")


def test_s2d_stem_engines_match_standard_stem_and_jax(ckpt_path):
    src = dict(num_frames=40, height=64, width=96, seed=1, events={20: 0, 30: 1})
    kw = dict(tta=True, dtype=torch.float32, device="cpu")
    chunked = {s2d: ChunkedVideoPredictor(ckpt_path, chunk_size=10, s2d_stem=s2d, **kw)
               for s2d in (False, True)}
    assert tuple(chunked[True].model.conv2d_encoder.conv_stem.weight.shape) == (8, 12, 2, 2)
    raws = {s2d: engine.predict_video(iter_source_frames(SyntheticSource(**src)), 40)[1]
            for s2d, engine in chunked.items()}
    np.testing.assert_allclose(raws[True], raws[False], atol=1e-5)
    _, j_raw = jax_get_raw_predictions(
        JaxStreamingPredictor(ckpt_path, tta=True, dtype=jnp.float32, s2d_stem=True),
        JaxSyntheticSource(**src), 40)
    _, s_raw = get_raw_predictions(StreamingPredictor(ckpt_path, s2d_stem=True, **kw),
                                   SyntheticSource(**src), 40)
    np.testing.assert_allclose(s_raw, j_raw, atol=1e-5)
    np.testing.assert_allclose(raws[True], j_raw, atol=1e-5)


MULTICHAN = dict(model_name=ARCH, num_classes=2, num_frames=6, stack_size=3, num_chans=3,
                 num_3d_blocks=1, num_3d_features=8, num_3d_stack_proj=8,
                 expansion_3d_ratio=2, se_reduce_3d_ratio=4)


def test_multichan_stacker_matches_jax():
    x = np.random.default_rng(1).random((2, 6, 3, 64, 96)).astype(np.float32)
    jmodel = jax_build_model("multichan_stacker", **MULTICHAN)
    tree = jax_init(jmodel, x, jit=True)
    expected = jax_apply(jmodel, tree, x, jit=True)
    model = build_model("multichan_stacker", **MULTICHAN).eval()
    model.load_state_dict(flax_tree_to_state_dict(tree))  # strict: every name maps
    assert tuple(model.conv2d_encoder.conv_stem.weight.shape) == (8, 9, 3, 3)
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x)).numpy(), expected)
        # channels of a stack are (frame, chan): frame 1's channel 0 is input channel 3
        stacks = torch.from_numpy(x[:, :3].reshape(2, 9, 64, 96))
        assert_close(model._encode(stacks).numpy(), model.forward_2d(torch.from_numpy(x))[:, 0])
    with pytest.raises(ValueError, match="C = 3"):
        model.forward_2d(torch.zeros(1, 6, 1, 64, 96))


@pytest.mark.parametrize("name,kwargs,channels_last", [
    ("timm", dict(model_name="tf_efficientnetv2_test.in1k", num_classes=3, in_chans=3,
                  pool="gem", drop_rate=0.1, pretrained=True), False),
    ("classifier2d", dict(model_name=ARCH, num_classes=2, pool="avg"), False),
    ("classifier2d", dict(model_name=ARCH, num_classes=2, channels_last=True), True),
    ("classifier2d", dict(model_name=ARCH, num_classes=2, pool="gem", channels_last=True), True),
])
def test_classifier2d_matches_jax(name, kwargs, channels_last):
    shape = (2, 64, 96, 3) if channels_last else (2, 3, 64, 96)
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    jmodel = jax_build_model(name, **kwargs)
    tree = jax_init(jmodel, x)
    expected = jax_apply(jmodel, tree, x)
    model = build_model(name, **kwargs).eval()
    model.load_state_dict(flax_tree_to_state_dict(tree))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    assert_close(out.numpy(), expected)
    assert ("global_pool.p" in model.state_dict()) == (kwargs.get("pool") == "gem")


def test_classifier2d_fold_matches_unfolded():
    """The ``encoder`` scope's TF-ported BNs fold with eps 1e-3, as JAX's
    ``tests/test_fold_bn.py::test_classifier2d_fold_matches_unfolded``."""
    kwargs = dict(model_name=ARCH, num_classes=3, pool="gem")
    x = torch.from_numpy(np.random.default_rng(1).random((2, 3, 64, 96)).astype(np.float32))
    jmodel = jax_build_model("classifier2d", **kwargs)
    state = flax_tree_to_state_dict(jax_init(jmodel, x.numpy()))
    model = build_model("classifier2d", **kwargs).eval()
    model.load_state_dict(state)
    folded = build_model("classifier2d", bn_folded=True, **kwargs).eval()
    folded.load_state_dict(fold_bn_state_dict(state))
    assert default_eps_rule(("encoder", "bn1")) == 1e-3
    with torch.no_grad():
        np.testing.assert_allclose(folded(x).numpy(), model(x).numpy(), atol=1e-4, rtol=1e-4)
