"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, run it without the repo's ``conftest.py``
(which loads JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips. Tolerances: float32 (TF32 off) atol 1e-5
on [0, 1] images and on the depthwise conv's unit-scale sums; bfloat16 and
float16 one rounding step, 2^-7·max|ref|; GeM 1e-4·max|ref| (float32 sums
in another order, and the special-function unit's log2 and exp2); the int8
conv exactly (its int32 sums and their dequantized values are the plain
version's, element for element); the folded BN's epilogue bit for bit
(the same rounding points and ATen's SiLU formula). The edge shapes and
tolerances are ``chip_smoke.py``'s."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ball_action_spotting_torch.models.effnetv2 import BatchNormAct
from ball_action_spotting_torch.ops.bias_act import KERNEL as BIAS_ACT_KERNEL
from ball_action_spotting_torch.ops.bias_act import bias_act, bias_act_reference
from ball_action_spotting_torch.ops.dwconv3d import KERNEL as DW_KERNEL
from ball_action_spotting_torch.ops.dwconv3d import dwconv3d, dwconv3d_reference
from ball_action_spotting_torch.ops.gem import KERNEL as GEM_KERNEL
from ball_action_spotting_torch.ops.se_scale import KERNEL as SE_SCALE_KERNEL
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_reference
from ball_action_spotting_torch.ops.int8_conv import CONV3X3_KERNEL as INT8_CONV3X3_KERNEL
from ball_action_spotting_torch.ops.int8_conv import GEMM_KERNEL as INT8_GEMM_KERNEL
from ball_action_spotting_torch.ops.int8_conv import KERNEL as INT8_KERNEL
from ball_action_spotting_torch.ops.int8_conv import int8_conv2d, int8_conv2d_reference
from ball_action_spotting_torch.ops.warp import KERNEL as WARP_KERNEL
from ball_action_spotting_torch.ops.warp import (
    resample_columns,
    resample_last_axis,
    resample_last_axis_reference,
)
from ball_action_spotting_torch.predict.export import (
    ExportedChunkPredictor,
    export_chunked_predictor,
)
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor
from chip_smoke import (
    DW_EDGE_CASES,
    DW_F32_ATOL,
    DW_ROUTE_CASES,
    DW_TOL,
    GEM_EDGE_CASES,
    GEM_TOL,
    INT8_EDGE_CASES,
    PRED_BF16_ATOL,
    WARP_EDGE_CASES,
    int8_inputs,
    route_input,
    tiny_weights,
    warp_edge_inputs,
    warp_tolerance,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["rows", "columns"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_matches_plain_version(cuda, dtype, axis):
    rng = np.random.default_rng(0)
    n, h, w, block = 3, 37, 96, 8
    img = torch.from_numpy(rng.random((n, h, w)).astype(np.float32)).to(cuda, dtype)
    length = h if axis == "rows" else w
    scale = torch.tensor([0.97, 1.0, 1.04], device=cuda)
    offsets = torch.from_numpy(
        np.linspace(2.0, -4.0, length, dtype=np.float32)[None] + 0.3 * np.arange(n)[:, None]
    ).float().to(cuda)
    offsets[1] = 500.0  # out of range: zero fill
    precision = "bfloat16" if dtype == torch.bfloat16 else "highest"
    if axis == "rows":
        out = resample_last_axis(img, scale, offsets, block, precision)
        ref = resample_last_axis_reference(img, scale, offsets, block, precision)
    else:
        out = resample_columns(img, scale, offsets, block, precision)
        ref = resample_last_axis_reference(img.transpose(1, 2), scale, offsets, block,
                                           precision).transpose(1, 2)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    tol = 2.0 ** -7 * ref.float().abs().max().item() if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), atol=tol)
    assert out[1].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", DW_EDGE_CASES)
def test_dwconv3d_kernel_edge_shapes(cuda, shape, dtype, offset):
    """The depthwise kernel against its plain version at the ring's, the
    tiles' and the copies' edges (see ``chip_smoke.DW_EDGE_CASES``)."""
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(
        rng.standard_normal(math.prod(shape) + offset).astype(np.float32)).to(cuda, dtype)
    x = flat[offset:].view(shape)
    k = torch.from_numpy(
        (rng.standard_normal((3, 3, 3, 1, shape[-1])) / 27 ** 0.5).astype(np.float32)).to(cuda)
    before = DW_KERNEL.launches
    out = dwconv3d(x, k)
    ref = dwconv3d_reference(x, k).float()
    torch.cuda.synchronize()
    assert DW_KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    tol = DW_F32_ATOL if dtype == torch.float32 else DW_TOL * ref.abs().max().item()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), atol=tol, rtol=0)


def _values(rng, cuda):
    return lambda numel: torch.from_numpy(rng.random(numel).astype(np.float32)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WARP_EDGE_CASES, ids=lambda case: str(case))
def test_warp_kernel_edge_shapes(cuda, case):
    """The warp kernel against its plain version on the one-element and the
    16-byte paths, odd blocks, flips and far scales, fp16, N 1 with H 1."""
    img, kernel, plain = warp_edge_inputs(case, _values(np.random.default_rng(0), cuda))
    before = WARP_KERNEL.launches
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    assert WARP_KERNEL.launches == before + 1
    assert out.dtype == img.dtype and out.shape == img.shape
    tol = warp_tolerance(img.dtype, case[6], ref)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", GEM_EDGE_CASES)
def test_gem_kernel_edge_shapes(cuda, shape, dtype, offset):
    """GeM's kernel against its plain version on both load widths, split
    and whole H·W, and a large B; two runs give the same bits."""
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(
        rng.standard_normal(math.prod(shape) + offset).astype(np.float32)).to(cuda, dtype)
    x = flat[offset:].view(shape)
    p = torch.tensor([3.0], device=cuda)
    before = GEM_KERNEL.launches
    out = gem_pool(x, p)
    ref = gem_pool_reference(x, p)
    torch.cuda.synchronize()
    assert GEM_KERNEL.launches == before + 1
    assert torch.equal(gem_pool(x, p), out)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=GEM_TOL * ref.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,layout,launches", DW_ROUTE_CASES)
def test_dwconv3d_route_shapes(cuda, shape, dtype, layout, launches):
    """Every shape JAX's dwconv3d computes: odd C, N past the grid, strided
    and misaligned x through the kernel; a W too wide to stage through the
    grouped conv."""
    rng = np.random.default_rng(0)
    x = route_input(shape, dtype, layout, lambda numel: torch.from_numpy(
        rng.standard_normal(numel).astype(np.float32)).to(cuda))
    k = torch.from_numpy(
        (rng.standard_normal((3, 3, 3, 1, shape[-1])) / 27 ** 0.5).astype(np.float32)).to(cuda)
    before = DW_KERNEL.launches
    out = dwconv3d(x, k)
    ref = dwconv3d_reference(x, k).float()
    torch.cuda.synchronize()
    assert DW_KERNEL.launches == before + launches
    assert out.dtype == dtype and out.shape == x.shape
    tol = DW_F32_ATOL if dtype == torch.float32 else DW_TOL * ref.abs().max().item()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset,route", INT8_EDGE_CASES,
                         ids=lambda case: str(case))
def test_int8_conv_edge_shapes(cuda, shape, dtype, offset, route):
    """The int8 conv's CUDA route (the GEMM kernel for a 1×1 it takes, the
    3×3 kernel for a 3×3 it takes, else the conv kernel) on a ``dtype`` x
    against the plain version, exactly, in int32 and ``dtype``."""
    x, s_x, w_q, s_w, pads = int8_inputs(cuda, shape, 7, dtype, offset)
    kernels = {"conv": INT8_KERNEL, "gemm": INT8_GEMM_KERNEL, "conv3x3": INT8_CONV3X3_KERNEL}
    for out_dtype in (dtype, torch.int32):
        for kernel in kernels.values():
            kernel.reset_counts()
        out = int8_conv2d(x, s_x, w_q, s_w, shape[-1], pads, out_dtype)
        torch.cuda.synchronize()
        assert {name: k.launches for name, k in kernels.items()} == {
            name: int(name == route) for name in kernels}
        ref = int8_conv2d_reference(x, s_x, w_q, s_w, shape[-1], *pads, out_dtype)
        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_custom_ops_launch_the_kernels(cuda):
    """Each ``bas_torch`` op launches its kernel on a CUDA tensor (one
    counted launch per call) and passes ``torch.library.opcheck`` there."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x4 = torch.rand(2, 3, 4, 8, generator=g, device=cuda)
    x5 = torch.rand(1, 3, 4, 5, 8, generator=g, device=cuda)
    k = torch.rand(3, 3, 3, 1, 8, generator=g, device=cuda)
    img = torch.rand(2, 5, 8, generator=g, device=cuda)
    p = torch.full((1,), 3.0, device=cuda)
    calls = [
        (GEM_KERNEL, torch.ops.bas_torch.gem_pool, (x4, p, 1e-6)),
        (DW_KERNEL, torch.ops.bas_torch.dwconv3d, (x5, k)),
        (WARP_KERNEL, torch.ops.bas_torch.warp_resample,
         (img, torch.ones(2, device=cuda), torch.zeros(2, 5, device=cuda), 4, "highest", 2)),
        (INT8_KERNEL, torch.ops.bas_torch.int8_conv2d,
         (*int8_inputs(cuda, (2, 9, 11, 16, 20, 3, 2), 1)[:4], 2, 0, 1, 1, 1, torch.bfloat16)),
        (INT8_CONV3X3_KERNEL, torch.ops.bas_torch.int8_conv2d,
         (*int8_inputs(cuda, (2, 9, 11, 16, 24, 3, 2), 1)[:4], 2, 0, 1, 1, 1, torch.bfloat16)),
        (INT8_GEMM_KERNEL, torch.ops.bas_torch.int8_conv2d,
         (*int8_inputs(cuda, (2, 9, 11, 16, 24, 1, 1), 2)[:4], 1, 0, 0, 0, 0, torch.bfloat16)),
        (BIAS_ACT_KERNEL, torch.ops.bas_torch.bias_act,
         (x5, torch.rand(8, generator=g, device=cuda), torch.rand_like(x5), "silu")),
        (SE_SCALE_KERNEL, torch.ops.bas_torch.se_scale,
         (x5, torch.rand(1, 8, generator=g, device=cuda))),
    ]
    for kernel, op, args in calls:
        kernel.reset_counts()
        op(*args)
        torch.cuda.synchronize()
        assert kernel.launches == 1, op
        results = torch.library.opcheck(op, args)
        assert set(results.values()) == {"SUCCESS"}, results


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])


def bias_act_inputs(cuda, shape, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x, r = (4 * torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    bias = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
    return x.to(dtype), bias, r.to(dtype)


def assert_kernel_is_plain(x, bias, r, act, launches=1):
    """One call of the op's kernel against the plain PyTorch sequence on
    the card, bit for bit."""
    BIAS_ACT_KERNEL.reset_counts()
    got = torch.ops.bas_torch.bias_act(x, bias, r, act)
    want = bias_act_reference(x, bias, r, act)
    torch.cuda.synchronize()
    assert BIAS_ACT_KERNEL.launches == launches
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("act,with_residual", [("silu", False), ("none", True), ("silu", True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("c", [8, 16, 24, 36, 576, 1152])
def test_bias_act_kernel_is_the_plain_version(cuda, c, dtype, act, with_residual):
    """Rows that are no multiple of the kernel's unroll or grid; C = 36 is
    no whole number of 16-byte vectors in bf16 and fp16 (one channel a
    thread)."""
    x, bias, r = bias_act_inputs(cuda, (3, 4099, c), dtype, c)
    assert_kernel_is_plain(x, bias, r if with_residual else None, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bias_act_silu_is_atens_on_every_16_bit_value(cuda, dtype):
    """Every bit pattern of the dtype through the kernel's SiLU (bias 0)
    against ``F.silu``: ATen's ``x / (1 + expf(-x))`` in float32."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda).to(
        torch.int16).view(dtype).reshape(-1, 8)
    assert_kernel_is_plain(x, torch.zeros(8, dtype=dtype, device=cuda), None, "silu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,act,with_residual", [
    ((256, 368, 640, 32), "silu", False),  # the stem's output, NHWC
    ((256, 184, 320, 128), "silu", False),  # blocks_1_1.conv_exp's
    ((256, 5, 23, 40, 576), "silu", False),  # the 3D head's bn1 and bn2
    ((256, 5, 23, 40, 192), "none", True),  # its bn3 and skip
])
def test_bias_act_kernel_at_the_prediction_shapes(cuda, shape, act, with_residual):
    x, bias, r = bias_act_inputs(cuda, shape, torch.bfloat16, 7)
    assert_kernel_is_plain(x, bias, r if with_residual else None, act)
    del x, r
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["misaligned", "strided", "channels_last_nchw", "tail", "nchw"])
def test_bias_act_routes(cuda, case):
    """Every folded BN's epilogue on the card launches the kernel: a
    pointer off a 16-byte boundary and a C that fills no whole vector (one
    element a thread), a view that is not dense (made dense with the
    channels last first), a channels-last NCHW tensor and a contiguous one
    (a plane per channel). Each gives the plain sequence's bits and
    layout."""
    x, bias, r = bias_act_inputs(cuda, (2, 9, 11, 40), torch.bfloat16, 3)
    channels_last = True
    if case == "misaligned":
        x = x.flatten()[1:].view(-1)[: 2 * 9 * 11 * 39].view(2, 9, 11, 39)
        bias, r = bias[:39], r[..., :39].contiguous()
    elif case == "strided":
        x = x[:, :, ::2]
        r = r[:, :, ::2]
    elif case == "channels_last_nchw":
        x, r, channels_last = x.permute(0, 3, 1, 2), r.permute(0, 3, 1, 2), False
    elif case == "nchw":
        x, r = x.permute(0, 3, 1, 2).contiguous(), r.permute(0, 3, 1, 2).contiguous()
        channels_last = False
    else:
        x, bias, r = x[..., :36].contiguous(), bias[:36], r[..., :36].contiguous()
    BIAS_ACT_KERNEL.reset_counts()
    got = bias_act(x, bias, F.silu, r, channels_last)
    shape = (-1,) if channels_last else (-1, 1, 1)
    want = F.silu(x + bias.view(shape)) + r
    torch.cuda.synchronize()
    assert BIAS_ACT_KERNEL.launches == 1
    assert got.stride() == want.stride() and torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("act,with_residual", [("silu", False), ("none", True), ("silu", True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("hw", [(23, 40), (5, 7), (368, 640)])
def test_bias_act_kernel_on_channel_planes(cuda, hw, dtype, act, with_residual):
    """A contiguous NCHW tensor (the serving engines' stem output) is read
    as a plane per channel and written in the same layout, bit for bit the
    plain sequence: 16-byte vectors where H·W allows, else one element a
    thread (5 × 7); the stem's 368 × 640 at 2 images."""
    x, bias, r = bias_act_inputs(cuda, (2, *hw, 32), dtype, hw[0])
    x, r = (t.permute(0, 3, 1, 2).contiguous() for t in (x, r))
    r = r if with_residual else None
    BIAS_ACT_KERNEL.reset_counts()
    got = bias_act(x, bias, F.silu if act == "silu" else None, r, channels_last=False)
    want = bias_act_reference(x.movedim(1, -1), bias, None if r is None else r.movedim(1, -1),
                              act).movedim(-1, 1)
    torch.cuda.synchronize()
    assert BIAS_ACT_KERNEL.launches == 1 and got.is_contiguous()
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
def test_export_on_the_card_holds_the_bias_act_op(cuda, tmp_path):
    """A folded predictor sealed on the card (``torch.export`` traces it
    with fake tensors) holds one ``bas_torch::bias_act`` node per folded BN,
    and the sealed program launches the kernel once per node and chunk
    program (one GeM launch each)."""
    model, params, video = tiny_weights()
    live = ChunkedVideoPredictor(weights=(model.state_dict(), params), device=cuda,
                                 chunk_size=8, dtype=torch.bfloat16, dw3d_use_kernel=True,
                                 carry_features=False)
    sealed = ExportedChunkPredictor(export_chunked_predictor(live, tmp_path / "t.bastorx"),
                                    device=cuda)
    bns = sum(isinstance(m, BatchNormAct) and m.folded for m in live.model.modules())
    targets = [str(n.target) for n in sealed.program.graph.nodes if n.op == "call_function"]
    assert bns > 0 and targets.count("bas_torch.bias_act.default") == bns
    BIAS_ACT_KERNEL.reset_counts()
    GEM_KERNEL.reset_counts()
    idx, raw = sealed.predict_video(iter(enumerate(video)), len(video))
    torch.cuda.synchronize()
    assert GEM_KERNEL.launches > 0 and BIAS_ACT_KERNEL.launches == bns * GEM_KERNEL.launches
    live_idx, live_raw = live.predict_video(iter(enumerate(video)), len(video))
    assert idx == live_idx and np.isfinite(raw).all()
    np.testing.assert_allclose(raw, live_raw, atol=PRED_BF16_ATOL)
