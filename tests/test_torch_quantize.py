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
from flax import linen as nn
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
from ball_action_spotting_torch.models import quantize as quantize_module
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
    conv3x3_plan,
    conv3x3_takes,
    dequantize,
    gemm_takes,
    int8_conv2d,
    int8_conv2d_op,
    int8_conv2d_sums_reference,
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
    sums = int8_conv2d(xt.permute(0, 2, 3, 1), s_x, w_q, s_w, stride, pads, torch.int32)
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
    x = torch.full((1, 3, 3, 1152), 127.0)
    w_q = torch.full((8, 3, 3, 1152), 127, dtype=torch.int8)
    w_q[1] = -127
    sums = int8_conv2d(x, torch.tensor(1.0), w_q, torch.ones(8), 1, (0, 0, 0, 0), torch.int32)
    assert sums.shape == (1, 1, 1, 8)
    assert sums[0, 0, 0, 0].item() == 127 * 127 * 9 * 1152 > 2**24
    assert sums[0, 0, 0, 1].item() == -127 * 127 * 9 * 1152


@pytest.mark.parametrize("shape,k,o,stride,pads,takes", [
    ((2, 23, 40, 64), 1, 24, 1, (0, 0, 0, 0), True),     # the flagship's 1×1 convs
    ((2, 23, 40, 12), 1, 24, 1, (0, 0, 0, 0), True),     # C off 16: the tail is masked
    ((1, 2, 4, 64), 1, 24, 1, (0, 0, 0, 0), False),      # M = 8 ≤ 16
    ((2, 23, 40, 64), 1, 17, 1, (0, 0, 0, 0), False),    # odd O
    ((2, 23, 40, 64), 1, 24, 2, (0, 0, 0, 0), False),    # stride 2
    ((2, 23, 40, 64), 1, 24, 1, (0, 1, 0, 1), False),    # padded
    ((2, 23, 40, 64), 3, 24, 1, (1, 1, 1, 1), False),    # k×k
    ((2, 23, 40, 1152), 1, 192, 1, (0, 0, 0, 0), True),  # weights in the TMA ring
    ((2, 23, 40, 1144), 1, 192, 1, (0, 0, 0, 0), False),  # ring weights, C off 16
    ((2, 23, 40, 24), 1, 1152, 1, (0, 0, 0, 0), True),   # C off 16, weights resident
    ((2, 23, 40, 260), 1, 272, 1, (0, 0, 0, 0), False),  # C off 16, 5 × 384 rows: the ring
])
def test_gemm_route_predicate(shape, k, o, stride, pads, takes):
    """The 1×1 GEMM kernel takes a 1×1 conv at stride 1 without padding
    over more than 16 pixels with an even O, whose x and weights TMA or the
    resident copy can read; the conv kernel the rest."""
    w_q = torch.zeros((o, k, k, shape[-1]), dtype=torch.int8)
    assert gemm_takes(torch.zeros(shape), w_q, stride, pads) is takes


@pytest.mark.parametrize("dtype,c,offset,takes", [
    (torch.bfloat16, 16, 0, True),
    (torch.bfloat16, 12, 0, False),   # rows of 24 bytes: not a multiple of 16
    (torch.bfloat16, 16, 1, False),   # x 2 bytes past a 16-byte boundary
    (torch.float32, 12, 0, True),     # rows of 48 bytes
    (torch.float32, 12, 2, False),    # x 8 bytes past a 16-byte boundary
])
def test_gemm_route_needs_rows_tma_reads(dtype, c, offset, takes):
    """x goes to the GEMM kernel only where TMA can read its rows:
    16-byte aligned, a multiple of 16 bytes long."""
    flat = torch.zeros(offset + 2 * 23 * 40 * c, dtype=dtype)
    x = flat[offset:].view(2, 23, 40, c)
    w_q = torch.zeros((24, 1, 1, c), dtype=torch.int8)
    assert gemm_takes(x, w_q, 1, (0, 0, 0, 0)) is takes


@pytest.mark.parametrize("shape,k,o,stride,takes", [
    ((2, 23, 40, 32), 3, 16, 1, True),     # blocks_0_0.conv: C 32 → 16
    ((2, 23, 40, 16), 3, 64, 2, True),     # blocks_1_0.conv_exp: stride 2, two taps a k32 step
    ((2, 23, 40, 48), 3, 192, 1, True),    # blocks_2_1.conv_exp: a step across two taps
    ((2, 23, 40, 8), 3, 8, 1, True),       # C 8: the unit's tail is TMA's zero fill
    ((2, 23, 40, 64), 3, 64, 1, False),    # C past 48
    ((2, 23, 40, 32), 3, 20, 1, False),    # O not a multiple of 8
    ((2, 23, 40, 32), 3, 200, 1, False),   # O past 192
    ((2, 23, 40, 32), 5, 32, 2, False),    # k 5
    ((2, 23, 40, 32), 1, 32, 2, False),    # 1×1 at stride 2
    ((2, 23, 40, 32), 3, 32, 3, False),    # stride 3
    ((2, 23, 40, 48), 3, 64, 2, False),    # no two ring stages fit
])
def test_conv3x3_route_predicate(shape, k, o, stride, takes):
    """The 3×3 kernel takes a 3×3 conv at stride 1 or 2 with C at most 48,
    O a multiple of 8 up to 192 and two ring stages that fit; the conv
    kernel the rest."""
    w_q = torch.zeros((o, k, k, shape[-1]), dtype=torch.int8)
    assert conv3x3_takes(torch.zeros(shape, dtype=torch.bfloat16), w_q, stride) is takes


@pytest.mark.parametrize("dtype,c,offset,takes", [
    (torch.bfloat16, 16, 0, True),
    (torch.bfloat16, 12, 0, False),   # rows of 24 bytes: not a multiple of 16
    (torch.bfloat16, 16, 1, False),   # x 2 bytes past a 16-byte boundary
    (torch.float32, 12, 0, True),     # rows of 48 bytes
    (torch.float32, 12, 2, False),    # x 8 bytes past a 16-byte boundary
    (torch.float16, 8, 0, True),      # rows of 16 bytes
])
def test_conv3x3_route_needs_rows_tma_reads(dtype, c, offset, takes):
    """x goes to the 3×3 kernel only where TMA can read its rows: 16-byte
    aligned, a multiple of 16 bytes long."""
    flat = torch.zeros(offset + 2 * 23 * 40 * c, dtype=dtype)
    x = flat[offset:].view(2, 23, 40, c)
    w_q = torch.zeros((16, 3, 3, c), dtype=torch.int8)
    assert conv3x3_takes(x, w_q, 1) is takes


@pytest.mark.parametrize("c,o,stride,esize,plan", [
    (32, 16, 1, 2, (3, 4, 2)),    # the flagship's five k×k convs in bf16
    (16, 64, 2, 2, (2, 2, 4)),
    (32, 128, 1, 2, (3, 1, 4)),
    (32, 128, 2, 2, (2, 1, 2)),   # a third consumer's two stages would not fit
    (48, 192, 1, 2, (2, 1, 3)),
    (32, 16, 1, 4, (2, 2, 3)),    # float32: nor here
    (8, 8, 1, 2, (3, 4, 5)),
    (32, 128, 2, 4, (2, 1, 1)),   # refused: blocks_2_0 in float32
])
def test_conv3x3_plan(c, o, stride, esize, plan):
    """The mirror of csrc/int8_conv3x3.cu's shared-memory plan: consumer
    warpgroups, m64 blocks a tile and ring stages (the card holds the
    kernel to it: a shape the predicate gives it and it refuses raises)."""
    assert conv3x3_plan(c, o, stride, esize) == plan


def test_cuda_route_is_gemm_then_conv3x3_then_conv(monkeypatch):
    """``_int8_conv2d_cuda_route`` asks ``gemm_takes`` first, then
    ``conv3x3_takes``; the conv kernel takes what both refuse."""
    taken = []
    for name in ("int8_gemm_cuda", "int8_conv3x3_cuda", "int8_conv_cuda"):
        monkeypatch.setattr(int8_ops, name, lambda *a, name=name: taken.append(name))
    s_x = torch.tensor(1.0)
    for k, o, c in ((1, 16, 32), (3, 16, 32), (3, 16, 64), (3, 20, 32)):
        x = torch.zeros((2, 9, 11, c), dtype=torch.bfloat16)
        w_q = torch.zeros((o, k, k, c), dtype=torch.int8)
        pads = (*same_pad(9, k, 1), *same_pad(11, k, 1))
        int8_ops._int8_conv2d_cuda_route(x, s_x, w_q, torch.ones(o), 1, *pads, torch.bfloat16)
    assert taken == ["int8_gemm_cuda", "int8_conv3x3_cuda", "int8_conv_cuda", "int8_conv_cuda"]


def conv3x3_kernel_sums(x_q: np.ndarray, w_q: np.ndarray, stride: int, pads,
                        blocks: int) -> np.ndarray:
    """The s32 sums of a 3×3 conv formed as ``csrc/int8_conv3x3.cu`` forms
    them, in int64 numpy: its resident weights, K-major (row o, 16-byte
    unit j = tap j // cs, channels 16 (j % cs).., zeros past C and past unit
    9·cs to an even count: two units a k32 step), and per tile (16 output
    columns by 4·``blocks`` rows) the int8 input box (zeros outside the image, the
    SAME padding), each position cs | 1 units apart, from which each
    pixel's row of A is gathered unit by unit at the kernel's ldmatrix
    offsets: ``pix`` (the pixel's first unit) plus ``koff`` (the unit's
    tap, dy rows and dx columns on, and segment)."""
    n, h, w, c = x_q.shape
    o = w_q.shape[0]
    cs = -(-c // 16)
    pu, units, steps = cs | 1, 9 * cs, (9 * cs + 1) // 2
    tile_h = 4 * blocks
    rh, rw = (tile_h - 1) * stride + 3, 15 * stride + 3
    pt, pb, pl, pr = pads
    ho, wo = (h + pt + pb - 3) // stride + 1, (w + pl + pr - 3) // stride + 1
    wt = np.zeros((o, 9, 16 * cs), np.int64)
    wt[..., :c] = w_q.reshape(o, 9, c)
    b = np.zeros((o, 2 * steps, 16), np.int64)
    b[:, :units] = wt.reshape(o, units, 16)

    def koff(j: int) -> int:
        tap, seg = divmod(j, cs) if j < units else (0, 0)
        return ((tap // 3) * rw + tap % 3) * pu + seg

    offs = np.array([koff(j) for j in range(2 * steps)])
    m = np.arange(16 * tile_h)
    pix = ((m // 16) * rw + m % 16) * stride * pu
    tiles_y, tiles_x = -(-ho // tile_h), -(-wo // 16)
    image = np.zeros((n, tiles_y * tile_h * stride + rh, tiles_x * 16 * stride + rw, 16 * cs),
                     np.int64)
    image[:, pt:pt + h, pl:pl + w, :c] = x_q
    sums = np.zeros((n, tiles_y * tile_h, tiles_x * 16, o), np.int64)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * tile_h * stride, tx * 16 * stride
            box = image[:, y0:y0 + rh, x0:x0 + rw].reshape(n, rh * rw, cs, 16)
            q = np.zeros((n, rh * rw, pu, 16), np.int64)
            q[:, :, :cs] = box
            a = q.reshape(n, rh * rw * pu, 16)[:, pix[:, None] + offs[None, :]]
            tile = np.einsum("nmju,oju->nmo", a, b).reshape(n, tile_h, 16, o)
            sums[:, ty * tile_h:(ty + 1) * tile_h, tx * 16:(tx + 1) * 16] = tile
    return sums[:, :ho, :wo]


@pytest.mark.parametrize("c,o,stride,h,w", [
    (16, 16, 1, 9, 21),    # two taps a k32 step, two m64 blocks, ragged tiles
    (16, 64, 2, 11, 13),   # stride 2 at odd H and W: the extra SAME row and column
    (32, 128, 1, 7, 18),   # one tap a step, one m64 block
    (32, 16, 2, 9, 35),
    (48, 192, 1, 6, 17),   # a step across two taps
    (48, 64, 2, 9, 11),
    (24, 40, 1, 5, 9),     # a unit's tail past C
])
def test_conv3x3_k_order_gives_the_plain_sums(c, o, stride, h, w):
    """The 3×3 kernel's K order and addressing (``conv3x3_kernel_sums``, at
    the tile height of the instance it launches for bfloat16 x) give
    ``int8_conv2d_sums_reference``'s sums exactly at C 16, 32 and 48,
    strides 1 and 2, on small images."""
    rng = np.random.default_rng(c * o + stride)
    x_q = rng.integers(-127, 128, (2, h, w, c), dtype=np.int8)
    w_q = rng.integers(-127, 128, (o, 3, 3, c), dtype=np.int8)
    pads = (*same_pad(h, 3, stride), *same_pad(w, 3, stride))
    ref = int8_conv2d_sums_reference(torch.from_numpy(x_q), torch.from_numpy(w_q), stride, pads)
    blocks = conv3x3_plan(c, o, stride, 2)[1]
    np.testing.assert_array_equal(conv3x3_kernel_sums(x_q, w_q, stride, pads, blocks), ref.numpy())


def int8_case(shape: tuple, o: int, k: int, dtype: torch.dtype, seed: int):
    """Seeded x (N, H, W, C) in ``dtype`` with an outlier, its s_x, and a
    seeded int8 w_q (O, k, k, C) with its s_w."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=shape) * 2).astype(np.float32)).to(dtype)
    x.view(-1)[7] = 9.5
    s_x = activation_scale(abs_max(x))
    w_q = torch.from_numpy(rng.integers(-127, 128, (o, k, k, shape[-1]), dtype=np.int8))
    s_w = torch.from_numpy(rng.uniform(1e-3, 1e-2, o).astype(np.float32))
    return x, s_x, w_q, s_w


def test_int8_conv2d_opcheck_and_dtypes():
    """``torch.library.opcheck`` on the schema (compute-dtype x, the 0-dim
    s_x, int8 weights, s_w), each output dtype from each input dtype, and
    the refusals."""
    for in_dtype in (torch.float32, torch.bfloat16, torch.float16):
        x, s_x, w_q, s_w = int8_case((2, 7, 9, 16), 24, 3, in_dtype, 0)
        for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
            torch.library.opcheck(int8_conv2d_op, (x, s_x, w_q, s_w, 2, 0, 1, 1, 1, dtype))
            out = int8_conv2d(x, s_x, w_q, s_w, 2, (0, 1, 1, 1), dtype)
            assert out.shape == (2, 3, 5, 24) and out.dtype == dtype
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        int8_conv2d(x.to(torch.int8), s_x, w_q, s_w, 1, (1, 1, 1, 1), torch.float32)
    with pytest.raises(ValueError, match="0-dim s_x"):
        int8_conv2d(x, s_x.reshape(1), w_q, s_w, 1, (1, 1, 1, 1), torch.float32)
    with pytest.raises(ValueError, match="s_w"):
        int8_conv2d(x, s_x, w_q, s_w[:3], 1, (1, 1, 1, 1), torch.float32)
    with pytest.raises(ValueError, match="weights"):
        int8_conv2d(x, s_x, w_q.float(), s_w, 1, (1, 1, 1, 1), torch.float32)


@pytest.mark.parametrize("shape,o,k,stride,dtype", [
    ((2, 11, 13, 8), 8, 3, 1, torch.float16),      # C 8
    ((3, 9, 33, 24), 40, 3, 2, torch.bfloat16),    # C 24, stride 2
    ((2, 9, 10, 24), 40, 1, 2, torch.float32),     # 1×1 at stride 2
    ((2, 6, 8, 32), 16, 1, 1, torch.bfloat16),     # the GEMM's shape
    ((2, 12, 20, 48), 17, 3, 1, torch.float32),    # odd O
])
def test_plain_route_is_quantize_sums_dequantize(shape, o, k, stride, dtype):
    """The op on a CPU tensor is ``quantize``, the exact sums and
    ``dequantize`` by ``s_x · s_w``, bitwise, in int32 and the compute
    dtype."""
    x, s_x, w_q, s_w = int8_case(shape, o, k, dtype, sum(shape) + o)
    pads = (*same_pad(shape[1], k, stride), *same_pad(shape[2], k, stride))
    sums = int8_conv2d_sums_reference(quantize(x, s_x), w_q, stride, pads)
    for out_dtype in (torch.int32, dtype):
        got = int8_conv2d(x, s_x, w_q, s_w, stride, pads, out_dtype)
        torch.testing.assert_close(got, dequantize(sums, s_x * s_w, out_dtype), rtol=0, atol=0)


def test_bands_hand_float_windows_to_the_op(monkeypatch):
    """On bands the op gets windows of the float bands, not quantized ones,
    and one scale for them all."""
    seen = []
    op = int8_ops.int8_conv2d_op

    def spy(x, s_x, *args):
        seen.append((x.dtype, s_x.item()))
        return op(x, s_x, *args)

    monkeypatch.setattr(int8_ops, "int8_conv2d_op", spy)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 16, 9, 7)).astype(np.float32))
    conv = QuantConv(16, 8, 3, 1)
    torch.nn.init.normal_(conv.weight)
    with torch.inference_mode():
        conv(bands_of(x, ["cpu"] * 3, balanced_cuts(9, 3), axis=2))
    assert len(seen) == 3 and {s for s in seen} == {(torch.float32, seen[0][1])}


def test_weight_quantization_is_cached_per_weight_version(monkeypatch):
    """``weight_scale`` runs once per weight version: the cached w_q and s_w
    are a fresh ``weight_scale``'s bits; ``load_state_dict``, an in-place
    rescale (as BN folding scales each output channel) and a move compute
    them again."""
    calls = []
    fresh = quantize_module.weight_scale

    def counting(w):
        calls.append(1)
        return fresh(w)

    monkeypatch.setattr(quantize_module, "weight_scale", counting)
    conv = QuantConv(16, 8, 3, 2)
    torch.nn.init.normal_(conv.weight)
    x = torch.randn(2, 16, 7, 9, generator=torch.Generator().manual_seed(0))

    def check(expected_calls):
        with torch.inference_mode():
            first = conv(x)
            torch.testing.assert_close(conv(x), first, rtol=0, atol=0)
        w_q, s_w = conv.quantized_weight(torch.device("cpu"))
        ref_q, ref_s = fresh(conv.weight)
        assert torch.equal(w_q, ref_q) and torch.equal(s_w, ref_s)
        assert len(calls) == expected_calls

    check(1)
    conv.load_state_dict({"weight": conv.weight.detach() * 3 + 0.25})
    check(2)
    with torch.no_grad():
        conv.weight.mul_(torch.linspace(0.5, 1.5, 8)[:, None, None, None])
    check(3)
    conv.to(torch.float64).to(torch.float32)
    check(4)


GRAD_RTOL = 1e-5  # × max|JAX's gradient|: float32 sums of g · y in another order


@pytest.mark.parametrize("k", [1, 3])
def test_quantconv_gradient_matches_jax(k):
    """``jax.grad`` through JAX's jitted ``QuantConv`` and the port's
    backward (``bas_torch::int8_conv2d``'s formula, the differentiable
    scales) agree on x and the weight in float32: zero through the rounding,
    the dequantizing product's gradient through s_x's max to x and s_w's
    per-channel max to the weight."""
    rng = np.random.default_rng(40 + k)
    x = (rng.normal(size=(2, 7, 9, 16)) * 2).astype(np.float32)
    g = rng.normal(size=(2, 7, 9, 24)).astype(np.float32)
    jconv = JaxQuantConv(features=24, kernel_size=(k, k))
    variables = jconv.init(jax.random.PRNGKey(k), jnp.asarray(x))

    def loss(v, xx):
        return jnp.sum(jconv.apply(v, xx) * g)

    grad_v, grad_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables, jnp.asarray(x))
    conv = port_quantconv(np.asarray(variables["params"]["kernel"]), 1)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    (conv(xt).permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    for got, ref in ((xt.grad.permute(0, 2, 3, 1), grad_x),
                     (conv.weight.grad.permute(2, 3, 1, 0), grad_v["params"]["kernel"])):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref).max())


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


# C11: the int8 decay at the flagship arch. Each quantized layer's output
# correlates with the float32 model's same layer less, the deeper it lies: on
# seeded b0 weights with BN calibrated on the input, JAX's curve falls from
# 0.99977 (blocks_0_0) to 0.855 (blocks_5_7.conv_pwl), the decay seen on the
# card. The port's curve follows it within DECAY_ATOL, a third of which it
# used (max |Δ| 3.1e-3 at the last layer, 1e-9 at the first): upstream
# float32 sums in another order move activations across int8 rounding
# boundaries, one step each, and the flips compound through 41 layers.
DECAY_ATOL = 0.01
B0_INPUT = (1, 192, 320, 3)


def seeded_b0_tree(seed: int):
    """JAX b0 encoder variables made with numpy (``jax.eval_shape`` for the
    shapes, no init run): kernels LeCun-normal, biases 0.01-normal, every BN
    randomized as ``to_numpy_tree`` does."""
    rng = np.random.default_rng(seed)
    x = jax.ShapeDtypeStruct(B0_INPUT, jnp.float32)
    shapes = jax.eval_shape(lambda xx: jax_b0(True).init(jax.random.PRNGKey(0), xx, train=False),
                            x)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if "bias" in name:
            return (rng.normal(size=s.shape) * 0.01).astype(np.float32)
        return np.full(s.shape, 1.0 if ("scale" in name or "var" in name) else 0.0, np.float32)

    return to_numpy_tree(jax.tree_util.tree_map_with_path(leaf, shapes), seed=seed)


def calibrated(tree, x: np.ndarray):
    """``tree`` with every BN's statistics those of its input on ``x`` in
    the float32 port (as ``chip_smoke.py`` calibrates the seeded flagship),
    so that activations stay normalized through the seeded network."""
    from ball_action_spotting_torch.models.effnetv2 import BatchNormAct

    model = EfficientNetV2Features("efficientnetv2_b0")
    model.load_state_dict(flax_tree_to_state_dict(tree), strict=True)
    stats = tree["batch_stats"]

    def hook(name):
        def set_stats(mod, args):
            node = stats
            for part in name.split("."):
                node = node[part]
            flat = args[0].permute(0, 2, 3, 1).reshape(-1, args[0].shape[1]).double()
            mod.running_mean.copy_(flat.mean(0))  # downstream sees the calibrated layer
            mod.running_var.copy_(flat.var(0))
            node["BatchNorm_0"]["mean"] = mod.running_mean.numpy().copy()
            node["BatchNorm_0"]["var"] = mod.running_var.numpy().copy()
        return set_stats

    handles = [m.register_forward_pre_hook(hook(name)) for name, m in model.named_modules()
               if isinstance(m, BatchNormAct)]
    with torch.no_grad():
        model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for h in handles:
        h.remove()
    return tree


def jax_b0(int8: bool):
    return JaxEfficientNetV2Features(model_name="efficientnetv2_b0", out_index=4,
                                     dtype=jnp.float32, conv_int8=int8)


def corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def test_int8_decay_matches_jax_at_b0():
    """C11: the same seeded b0 weights (numpy, carried by ``convert.py``)
    and a float32 192×320 input through JAX's and the port's encoders, int8
    and float32; each of the 41 quantized layers' int8-against-float32
    correlation in the port within ``DECAY_ATOL`` of JAX's."""
    x = np.random.default_rng(11).random(B0_INPUT).astype(np.float32)
    tree = calibrated(seeded_b0_tree(11), x)
    is_conv = lambda mdl, name: (name == "__call__" and isinstance(mdl, (JaxQuantConv, nn.Conv))  # noqa: E731
                                 and mdl.feature_group_count == 1)
    jax_layers = {}
    for int8 in (True, False):
        _, state = jax.jit(lambda v, xx, int8=int8: jax_b0(int8).apply(
            v, xx, train=False, capture_intermediates=is_conv))(tree, jnp.asarray(x))
        for path, value in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
            name = ".".join(k.key for k in path if isinstance(k, jax.tree_util.DictKey))
            jax_layers.setdefault(name.removesuffix(".__call__"), {})[int8] = np.asarray(value)

    state_dict = flax_tree_to_state_dict(tree)
    port_layers = {}
    for int8 in (True, False):
        model = EfficientNetV2Features("efficientnetv2_b0", conv_int8=int8)
        model.load_state_dict(state_dict, strict=True)
        handles = [m.register_forward_hook(
            lambda mod, args, out, name=name, int8=int8: port_layers.setdefault(name, {}).update(
                {int8: out.permute(0, 2, 3, 1).numpy()}))
            for name, m in model.named_modules()
            if type(m) in (QuantConv, Conv2dSame) and m.groups == 1 and name != "conv_stem"]
        with torch.inference_mode():
            model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        for h in handles:
            h.remove()
    names = [n for n in jax_layers if n in port_layers]  # JAX's order; its SE convs aside
    assert len(names) == len(port_layers) == 41
    decay_jax = [corr(jax_layers[n][True], jax_layers[n][False]) for n in names]
    decay_port = [corr(port_layers[n][True], port_layers[n][False]) for n in names]
    np.testing.assert_allclose(decay_port, decay_jax, atol=DECAY_ATOL, rtol=0)
    assert decay_jax[0] > 0.999 and decay_jax[-1] < 0.9  # JAX's own decay, which the port follows
