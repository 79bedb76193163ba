"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, run it without the repo's ``conftest.py``
(which loads JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips. Tolerances: float32 (TF32 off) atol 1e-5
on [0, 1] images and on the depthwise conv's unit-scale sums; bfloat16 and
float16 one rounding step, 2^-7·max|ref|; GeM 1e-4·max|ref| (float32 sums
in another order, and the special-function unit's log2 and exp2). The edge
shapes and tolerances are ``chip_smoke.py``'s."""

import math

import numpy as np
import pytest
import torch

from ball_action_spotting_torch.ops.dwconv3d import KERNEL as DW_KERNEL
from ball_action_spotting_torch.ops.dwconv3d import dwconv3d, dwconv3d_reference
from ball_action_spotting_torch.ops.gem import KERNEL as GEM_KERNEL
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_reference
from ball_action_spotting_torch.ops.warp import KERNEL as WARP_KERNEL
from ball_action_spotting_torch.ops.warp import (
    resample_columns,
    resample_last_axis,
    resample_last_axis_reference,
)
from chip_smoke import (
    DW_EDGE_CASES,
    DW_F32_ATOL,
    DW_ROUTE_CASES,
    DW_TOL,
    GEM_EDGE_CASES,
    GEM_TOL,
    WARP_EDGE_CASES,
    route_input,
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
