"""The port's int8 encoder convs (``models/quantize.py``,
``ops/int8_conv.py``) against the JAX package's ``models/quantize.py`` on
the CPU, after ``tests/test_quantize.py``.

JAX runs its ``QuantConv`` jitted, as its engines do (XLA folds ``/ 127.0``
into a product with the float32 reciprocal; the port computes the same).
Tolerances:
- ``QuantConv``: x_q, w_q and the int32 sums equal; the output bitwise
  equal, in float32 and bfloat16.
- The tiny encoder (float32, JAX's test's input): the mean |port − JAX|
  at most a tenth of the mean |JAX int8 − JAX float32| on the same input
  (JAX's test measures drift by the mean), and the max at most a quarter
  of JAX's max drift. Upstream float32 sums in another order (port vs JAX
  float32 3e-8 here) move a value across a rounding boundary and change it
  by one int8 step: on this input 24 of 288 outputs move, by up to 4.5e-4
  (0.22 of JAX's max drift, 0.034 of its mean). JAX's own bounds against
  float32 (correlation > 0.99, mean relative drift < 0.1) hold on the
  port.
- ``build_model("multidim_stacker", conv2d_int8=True)``: finite, (1, 2),
  within 1e-5 of JAX's logits.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.models.effnetv2 import (
    EfficientNetV2Features as JaxEfficientNetV2Features,
)
from ball_action_spotting_tpu.models.quantize import QuantConv as JaxQuantConv
from ball_action_spotting_torch.convert import flax_tree_to_state_dict
from ball_action_spotting_torch.models import build_model
from ball_action_spotting_torch.models.effnetv2 import (
    Conv2dSame,
    EfficientNetV2Features,
    same_pad,
)
from ball_action_spotting_torch.models.quantize import (
    QuantConv,
    ScaleGroup,
    abs_max,
    activation_scale,
    quantize,
    run_shares,
    weight_scale,
)
from ball_action_spotting_torch.ops import int8_conv as int8_ops
from ball_action_spotting_torch.ops.int8_conv import (
    int8_conv2d,
    int8_conv2d_op,
    int8_conv2d_reference,
    int_mm_takes,
)
from ball_action_spotting_torch.parallel.spatial import COUNTS, balanced_cuts, bands_of
from tests.test_torch_models import NN_KWARGS, to_numpy_tree

ENCODER_MEAN_OF_DRIFT = 0.1   # mean |port − JAX| over mean |JAX int8 − JAX float32|
ENCODER_MAX_OF_DRIFT = 0.25   # max |port − JAX| over max |JAX int8 − JAX float32|
MODEL_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_quantconv_parts(conv: JaxQuantConv, variables, x: np.ndarray, monkeypatch):
    """JAX's jitted ``QuantConv`` on x: (output, x_q, w_q, int32 sums), the
    last three the arguments and result of its one integer conv."""
    captured = []
    conv_general_dilated = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        out = conv_general_dilated(lhs, rhs, *args, **kwargs)
        captured.append((lhs, rhs, out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)

    @jax.jit
    def run(v, xx):
        out = conv.apply(v, xx)
        return (out, *captured[-1])

    return [np.asarray(a) for a in run(variables, jnp.asarray(x))]


def port_quantconv(kernel_hwio: np.ndarray, stride: int, groups: int = 1) -> QuantConv:
    kh, _, cin_g, cout = kernel_hwio.shape
    conv = QuantConv(cin_g * groups, cout, kh, stride, groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel_hwio.transpose(3, 2, 0, 1).copy()))
    return conv


@pytest.mark.parametrize("k,stride,h,w,cin,dtype", [
    (3, 1, 9, 12, 16, "float32"),
    (3, 2, 10, 13, 48, "float32"),
    (3, 2, 9, 9, 16, "bfloat16"),
    (1, 1, 7, 8, 16, "bfloat16"),
    (1, 2, 9, 8, 48, "float32"),
    (3, 1, 8, 11, 48, "bfloat16"),
])
def test_quantconv_matches_jax(monkeypatch, k, stride, h, w, cin, dtype):
    """x_q, w_q and the s32 sums equal to JAX's; the output bitwise."""
    rng = np.random.default_rng(k * 100 + stride * 10 + cin)
    x = (rng.normal(size=(2, h, w, cin)) * 3).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jconv = JaxQuantConv(features=24, kernel_size=(k, k), strides=stride, dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    variables = jconv.init(jax.random.PRNGKey(0), xj)
    out_j, xq_j, wq_j, sums_j = jax_quantconv_parts(jconv, variables, np.asarray(xj), monkeypatch)
    conv = port_quantconv(np.asarray(variables["params"]["kernel"]), stride)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)

    w_q, s_w = weight_scale(conv.weight)
    np.testing.assert_array_equal(w_q.numpy(), wq_j.transpose(3, 0, 1, 2))
    s_x = activation_scale(abs_max(xt))
    x_q = quantize(xt, s_x)
    np.testing.assert_array_equal(x_q.permute(0, 2, 3, 1).numpy(), xq_j)
    pads = (*same_pad(h, k, stride), *same_pad(w, k, stride))
    sums = int8_conv2d(x_q.permute(0, 2, 3, 1), w_q, s_x * s_w, stride, pads, torch.int32)
    np.testing.assert_array_equal(sums.numpy(), sums_j)
    with torch.inference_mode():
        out = conv(xt)
    assert out.dtype == tdt
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).float().numpy(),
                                  out_j.astype(np.float32))


def test_grouped_quantconv_takes_the_compute_dtype_conv(monkeypatch):
    """A depthwise ``QuantConv`` is ``Conv2dSame``'s conv (JAX's grouped
    path lowers no int8 op), equal to JAX's, and calls no s8 op."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 8, 8, 8)).astype(np.float32)
    jconv = JaxQuantConv(features=8, kernel_size=(3, 3), feature_group_count=8)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    expected = np.asarray(jax.jit(jconv.apply)(variables, jnp.asarray(x)))
    conv = port_quantconv(np.asarray(variables["params"]["kernel"]), 1, groups=8)
    plain = Conv2dSame(8, 8, 3, 1, groups=8)
    plain.load_state_dict(conv.state_dict())
    monkeypatch.setattr(int8_ops, "int8_conv2d_op", lambda *a: pytest.fail("s8 op called"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = conv(xt)
        torch.testing.assert_close(out, plain(xt), rtol=0, atol=0)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), expected, atol=1e-5)


def test_plain_sums_are_exact_beyond_float32():
    """The plain version sums exactly where float32 cannot (sums past
    2^24): every product 127 · 127 over a 3 × 3 × 1152 window."""
    x_q = torch.full((1, 3, 3, 1152), 127, dtype=torch.int8)
    w_q = torch.full((8, 3, 3, 1152), 127, dtype=torch.int8)
    w_q[1] = -127
    sums = int8_conv2d(x_q, w_q, torch.ones(8), 1, (0, 0, 0, 0), torch.int32)
    assert sums.shape == (1, 1, 1, 8)
    assert sums[0, 0, 0, 0].item() == 127 * 127 * 9 * 1152 > 2**24
    assert sums[0, 0, 0, 1].item() == -127 * 127 * 9 * 1152


@pytest.mark.parametrize("shape,k,stride,pads,takes", [
    ((2, 23, 40, 64), 1, 1, (0, 0, 0, 0), True),     # the flagship's 1×1 convs
    ((1, 2, 4, 64), 1, 1, (0, 0, 0, 0), False),      # M = 8 ≤ 16
    ((2, 23, 40, 12), 1, 1, (0, 0, 0, 0), False),    # C not a multiple of 8
    ((2, 23, 40, 64), 1, 2, (0, 0, 0, 0), False),    # stride 2
    ((2, 23, 40, 64), 3, 1, (1, 1, 1, 1), False),    # k×k
])
def test_int_mm_route_predicate(shape, k, stride, pads, takes):
    w_q = torch.zeros((24, k, k, shape[-1]), dtype=torch.int8)
    assert int_mm_takes(torch.zeros(shape, dtype=torch.int8), w_q, stride, pads) is takes


def test_int_mm_refuses_an_output_width_off_eight():
    assert not int_mm_takes(torch.zeros((2, 23, 40, 64), dtype=torch.int8),
                            torch.zeros((20, 1, 1, 64), dtype=torch.int8), 1, (0, 0, 0, 0))


def test_int8_conv2d_opcheck_and_dtypes():
    g = torch.Generator().manual_seed(0)
    x_q = torch.randint(-127, 128, (2, 7, 9, 16), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (24, 3, 3, 16), generator=g, dtype=torch.int8)
    scale = torch.rand(24, generator=g) * 1e-3
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        torch.library.opcheck(int8_conv2d_op, (x_q, w_q, scale, 2, 0, 1, 1, 1, dtype))
        out = int8_conv2d(x_q, w_q, scale, 2, (0, 1, 1, 1), dtype)
        assert out.shape == (2, 3, 5, 24) and out.dtype == dtype
    sums = int8_conv2d_reference(x_q, w_q, scale, 2, 0, 1, 1, 1, torch.int32)
    np.testing.assert_array_equal(
        int8_conv2d(x_q, w_q, scale, 2, (0, 1, 1, 1), torch.float32).numpy(),
        (sums.float() * scale).numpy())
    with pytest.raises(ValueError, match="int8"):
        int8_conv2d(x_q.float(), w_q, scale, 1, (1, 1, 1, 1), torch.float32)
    with pytest.raises(ValueError, match="scale"):
        int8_conv2d(x_q, w_q, scale[:3], 1, (1, 1, 1, 1), torch.float32)


def test_quantconv_has_no_backward():
    """Inference only: a gradient through the s8 op raises."""
    conv = QuantConv(16, 8, 3, 1)
    torch.nn.init.normal_(conv.weight)
    out = conv(torch.randn(1, 16, 5, 5))
    with pytest.raises(RuntimeError):
        out.sum().backward()


@pytest.mark.parametrize("n", [2, 3, 8])
def test_banded_quantconv_matches_unbanded(n):
    """On bands (empty ones too at n = 8): the scale is the max over every
    band, and the output equals the unbanded conv's bitwise."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(2, 16, 7, 9)).astype(np.float32))
    x[1, 3, 6, 4] = 40.0  # the largest |x| in the last band
    for k, stride in ((3, 1), (3, 2), (1, 1)):
        conv = QuantConv(16, 24, k, stride)
        torch.nn.init.normal_(conv.weight)
        with torch.inference_mode():
            ref = conv(x)
            COUNTS.reset()
            got = conv(bands_of(x, ["cpu"] * n, balanced_cuts(7, n), axis=2)).gather()
        assert COUNTS.band_maxes == 1
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_run_shares_takes_one_scale_over_the_shares():
    """Three shares of a batch, each in its thread of one scale group,
    quantize with the scale of the whole batch; the group's max is the max
    of every share's; a share that raises breaks the group."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(6, 16, 5, 5)).astype(np.float32))
    x[4, 0, 0, 0] = 25.0
    conv = QuantConv(16, 8, 3, 1)
    torch.nn.init.normal_(conv.weight)
    with torch.inference_mode():
        whole = conv(x)
        parts = run_shares([lambda p=p: conv(p) for p in x.split(2)], torch.device("cpu"))
        alone = conv(x[:2])
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)
    assert not torch.equal(alone, whole[:2])  # a share's own scale differs
    def fails():
        raise KeyError("share 1")

    with pytest.raises(KeyError, match="share 1"):
        run_shares([lambda: conv(x[:2]), fails], torch.device("cpu"))
    group = ScaleGroup(2, torch.device("cpu"))
    out = run_shares([lambda: group.max(0, torch.tensor(3.0)),
                      lambda: group.max(1, torch.tensor(5.0))], torch.device("cpu"))
    assert [o.item() for o in out] == [5.0, 5.0]


def test_scale_group_under_contention():
    """More shares than cores, a short switch interval, many rounds: every
    share gets every round's max, none a stale or partial one."""
    shares, rounds = 24, 200
    values = np.random.default_rng(3).random((rounds, shares)).astype(np.float32)
    group = ScaleGroup(shares, torch.device("cpu"))
    got = np.zeros_like(values)

    def share(i):
        def call():
            for r in range(rounds):
                got[r, i] = group.max(i, torch.tensor(values[r, i])).item()
        return call

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=run_shares,
                                  args=([share(i) for i in range(shares)], torch.device("cpu")))
        runner.start()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not runner.is_alive()
    np.testing.assert_array_equal(got, np.repeat(values.max(axis=1, keepdims=True), shares, 1))


def jax_encoder(int8: bool):
    return JaxEfficientNetV2Features(model_name="efficientnetv2_test", out_index=4,
                                     dtype=jnp.float32, conv_int8=int8)


def test_int8_encoder_matches_jax_and_tracks_f32():
    """The tiny int8 encoder: the same state tree as the float32 one (a JAX
    ``conv_int8=True`` tree loads strictly), JAX's int8 outputs within the
    module docstring's tolerance, and JAX's bounds against float32 on the
    port."""
    x = np.random.default_rng(1).random((2, 64, 96, 3)).astype(np.float32)
    variables = jax_encoder(True).init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    f32_shapes = jax.tree.map(jnp.shape, jax_encoder(False).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    assert jax.tree.map(jnp.shape, variables) == f32_shapes
    tree = to_numpy_tree(variables, seed=1)
    ref_int8 = np.asarray(jax.jit(lambda v, xx: jax_encoder(True).apply(v, xx, train=False))(
        tree, jnp.asarray(x)), np.float64)
    ref_f32 = np.asarray(jax.jit(lambda v, xx: jax_encoder(False).apply(v, xx, train=False))(
        tree, jnp.asarray(x)), np.float64)

    port = EfficientNetV2Features("efficientnetv2_test", conv_int8=True)
    state = flax_tree_to_state_dict(tree)
    port.load_state_dict(state, strict=True)
    plain = EfficientNetV2Features("efficientnetv2_test")
    assert plain.state_dict().keys() == port.state_dict().keys()
    plain.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantConv) for m in port.modules()) == 11  # 2 depthwise
    assert isinstance(port.conv_stem, Conv2dSame) and not isinstance(port.conv_stem, QuantConv)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = port.eval()(xt).permute(0, 2, 3, 1).double().numpy()
        f32 = plain.eval()(xt).permute(0, 2, 3, 1).double().numpy()
    diff, drift = np.abs(got - ref_int8), np.abs(ref_int8 - ref_f32)
    assert diff.mean() <= ENCODER_MEAN_OF_DRIFT * drift.mean(), (diff.mean(), drift.mean())
    assert diff.max() <= ENCODER_MAX_OF_DRIFT * drift.max(), (diff.max(), drift.max())
    corr = np.corrcoef(f32.ravel(), got.ravel())[0, 1]
    rel = np.abs(got - f32).mean() / (np.abs(f32).mean() + 1e-9)
    assert corr > 0.99 and rel < 0.1, (corr, rel)


def test_int8_model_flag_matches_jax():
    """``build_model("multidim_stacker", conv2d_int8=True)`` against JAX's:
    finite (1, 2) logits, the projection and the 3D head unquantized; the
    multi-channel stacker takes the flag through its base, the plain 2D
    classifier refuses it as JAX's does."""
    model_j = jax_build_model("multidim_stacker", dtype=jnp.float32, conv2d_int8=True,
                              **NN_KWARGS)
    x = np.random.default_rng(2).random((1, 6, 64, 96)).astype(np.float32)
    variables = model_j.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    tree = to_numpy_tree(variables, seed=2)
    expected = np.asarray(jax.jit(lambda v, xx: model_j.apply(v, xx, train=False))(
        tree, jnp.asarray(x)))
    model = build_model("multidim_stacker", conv2d_int8=True, **NN_KWARGS)
    model.load_state_dict(flax_tree_to_state_dict(tree), strict=True)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, expected, atol=MODEL_ATOL, rtol=0)
    assert not any(isinstance(m, QuantConv) for name, m in model.named_modules()
                   if not name.startswith("conv2d_encoder."))
    chan = build_model("multichan_stacker", num_chans=3, conv2d_int8=True, **NN_KWARGS)
    assert any(isinstance(m, QuantConv) for m in chan.modules())
    with pytest.raises(TypeError):
        build_model("classifier2d", model_name="efficientnetv2_test", conv2d_int8=True)
