"""Port ops against the JAX package: GeM (forward and gradients) and the
3×3×3 depthwise conv. The JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them; the port's wrappers take their plain
versions on CPU tensors.

Tolerance (float32): max|Δ| ≤ 1e-4·max|ref|, which allows for another order
of the float32 sums. The bfloat16 GeM case feeds both sides the same bf16
values and sums in float32, so it holds the same bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.ops.pallas_dwconv3d import (
    dwconv3d as jax_dwconv3d,
    dwconv3d_reference as jax_dwconv3d_reference,
)
from ball_action_spotting_tpu.ops.pallas_gem import gem_pool as jax_gem_pool
from ball_action_spotting_torch.ops import KERNELS
from ball_action_spotting_torch.ops.dwconv3d import (
    dwconv3d,
    dwconv3d_cuda,
    dwconv3d_grouped_conv,
    dwconv3d_reference,
    kernel_stages,
)
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_cuda, gem_splits
from ball_action_spotting_torch.ops.gem import wide_path as gem_wide_path
from ball_action_spotting_torch.ops.warp import resample_columns, resample_last_axis

RTOL = 1e-4


def assert_close(actual, expected, rtol=RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    bound = rtol * np.abs(expected).max()
    assert np.abs(actual - expected).max() <= bound


@pytest.fixture()
def gem_inputs():
    rng = np.random.default_rng(0)
    x = (rng.random((2, 5, 6, 256)) * 2.0).astype(np.float32)
    x[0, 0, 0, :8] = 0.0  # below eps: clamped
    p = np.asarray([3.0], np.float32)
    return x, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gem_forward_matches_jax(gem_inputs, dtype):
    x, p = gem_inputs
    jx = jnp.asarray(x).astype(dtype)
    expected = jax_gem_pool(jx, jnp.asarray(p), 1e-6, 128, True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    out = gem_pool(tx, torch.from_numpy(p))
    assert out.dtype == torch.float32
    assert_close(out.numpy(), expected)


def test_gem_grads_match_jax(gem_inputs):
    x, p = gem_inputs

    def loss(x, p):
        return jnp.sum(jax_gem_pool(x, p, 1e-6, 128, True) ** 2)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = torch.from_numpy(p).requires_grad_(True)
    (gem_pool(tx, tp) ** 2).sum().backward()
    assert_close(tx.grad.numpy(), gx)
    assert_close(tp.grad.numpy(), gp)
    assert np.all(tx.grad.numpy()[0, 0, 0, :8] == 0.0)  # clamped region


# then the CUDA kernel's tiling edges: one slice of 23 rows in ragged row
# tiles, C = 6, which the kernel stages with narrow copies, and odd C, which
# the CUDA route pads by one zero channel
@pytest.mark.parametrize("shape", [(2, 5, 7, 10, 32), (1, 3, 4, 6, 64), (1, 1, 3, 3, 8),
                                   (1, 1, 23, 40, 16), (1, 5, 23, 40, 6), (1, 3, 4, 6, 5)])
def test_dwconv3d_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 1, shape[-1])).astype(np.float32)
    expected = jax_dwconv3d(jnp.asarray(x), jnp.asarray(k), interpret=True)
    expected_lax = jax_dwconv3d_reference(jnp.asarray(x), jnp.asarray(k))
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    out = dwconv3d(tx, tk)
    assert out.dtype == torch.float32
    assert_close(out.numpy(), expected)
    assert_close(out.numpy(), expected_lax)
    assert_close(dwconv3d_reference(tx, tk).numpy(), expected)
    assert_close(dwconv3d_grouped_conv(tx, tk).numpy(), expected_lax)


def test_dwconv3d_keeps_bf16():
    x = torch.randn(1, 2, 3, 4, 8, generator=torch.Generator().manual_seed(0))
    out = dwconv3d(x.bfloat16(), torch.ones(3, 3, 3, 1, 8).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == x.shape


@pytest.mark.parametrize("case", ["gem_rank", "gem_p", "dw_rank", "dw_kernel"])
def test_wrappers_reject_bad_shapes(case):
    x4 = torch.ones(2, 3, 4, 8)
    x5 = torch.ones(1, 2, 3, 4, 8)
    with pytest.raises(ValueError):
        if case == "gem_rank":
            gem_pool(x5, torch.ones(1))
        elif case == "gem_p":
            gem_pool(x4, torch.ones(2))
        elif case == "dw_rank":
            dwconv3d(x4, torch.ones(3, 3, 3, 1, 8))
        else:
            dwconv3d(x5, torch.ones(3, 3, 1, 8))


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        gem_pool_cuda(torch.ones(2, 3, 4, 8), torch.ones(1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dwconv3d_cuda(torch.ones(1, 2, 3, 4, 8), torch.ones(3, 3, 3, 1, 8))


def test_launch_counters_stay_zero_on_cpu():
    for kernel in KERNELS:
        kernel.launches = 0
    gem_pool(torch.rand(2, 3, 4, 8), torch.full((1,), 3.0))
    dwconv3d(torch.rand(1, 2, 3, 4, 8), torch.rand(3, 3, 3, 1, 8))
    resample_last_axis(torch.rand(2, 3, 8), torch.ones(2), torch.zeros(2, 3))
    assert [k.name for k in KERNELS] == ["gem", "dwconv3d", "warp"]
    assert [k.launches for k in KERNELS] == [0, 0, 0]


# csrc/dwconv3d.cu stages three rows of 3 slots × W × 32 channel pairs in at
# most 227 KB: 384·W bytes in bf16/fp16 (W ≤ 201), 768·W in float32 (W ≤ 100)
@pytest.mark.parametrize("w,dtype,stages", [
    (40, torch.bfloat16, True), (96, torch.bfloat16, True), (201, torch.bfloat16, True),
    (202, torch.bfloat16, False), (201, torch.float16, True), (202, torch.float16, False),
    (40, torch.float32, True), (100, torch.float32, True), (101, torch.float32, False),
    (128, torch.float32, False),
])
def test_dwconv3d_staging_predicate(w, dtype, stages):
    assert kernel_stages(w, dtype) is stages


@pytest.mark.parametrize("shape,dtype,offset,wide", [
    ((1280, 23, 40, 256), torch.bfloat16, 0, True),   # inference head, hflip TTA on
    ((4, 23, 40, 1280), torch.bfloat16, 0, True),     # train head
    ((2, 3, 4, 8), torch.float16, 0, True),
    ((2, 3, 4, 12), torch.float32, 0, True),           # 48 bytes a position
    ((2, 3, 4, 6), torch.float32, 0, False),           # 24 bytes a position
    ((2, 3, 4, 6), torch.bfloat16, 0, False),          # 12 bytes a position
    ((2, 3, 4, 256), torch.bfloat16, 1, False),        # one element past a 16-byte boundary
])
def test_gem_wide_path_predicate(shape, dtype, offset, wide):
    flat = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    assert gem_wide_path(flat[offset:].view(shape)) is wide


@pytest.mark.parametrize("b,hw,c,vec,splits", [
    (1280, 920, 256, 8, 1),  # inference head: 1280 tiles fill 132 SMs
    (640, 920, 256, 8, 1),
    (4, 920, 1280, 8, 14),   # train head: 20 tiles, split to 280 blocks
    (4, 920, 1280, 1, 2),    # one channel a lane: 160 tiles
    (1, 1, 8, 8, 1),         # one position cannot be split
    (2, 40, 8, 8, 2),        # at least 16 positions (4 per warp) a split
])
def test_gem_splits(b, hw, c, vec, splits):
    assert gem_splits(b, hw, c, vec, sms=132) == splits


@pytest.mark.parametrize("case", ["gem_strided_fp16", "dwconv3d_odd_c", "dwconv3d_strided",
                                  "warp_h_fp16", "warp_v_strided"])
def test_cpu_wrappers_count_no_launch(case):
    """On CPU tensors every wrapper takes its plain version, also for the
    inputs that the CUDA route reshapes (odd C, strided, fp16)."""
    for kernel in KERNELS:
        kernel.reset_counts()
    g = torch.Generator().manual_seed(0)
    if case == "gem_strided_fp16":
        x = torch.rand(2, 4, 3, 8, generator=g).half().transpose(1, 2)
        assert gem_pool(x, torch.full((1,), 3.0)).shape == (2, 8)
    elif case.startswith("dwconv3d"):
        c = 5 if case == "dwconv3d_odd_c" else 8
        x = torch.rand(1, 2, 4, 3, c, generator=g)
        x = x if case == "dwconv3d_odd_c" else x.transpose(2, 3)
        assert dwconv3d(x, torch.rand(3, 3, 3, 1, c, generator=g)).shape == x.shape
    elif case == "warp_h_fp16":
        img = torch.rand(2, 3, 8, generator=g).half()
        out = resample_last_axis(img, torch.ones(2), torch.zeros(2, 3))
        assert out.dtype == torch.float16
    else:
        img = torch.rand(2, 8, 3, generator=g).transpose(1, 2)
        assert resample_columns(img, torch.ones(2), torch.zeros(2, 8)).shape == (2, 3, 8)
    assert [k.launches for k in KERNELS] == [0, 0, 0]
    assert all(not k.launches_by for k in KERNELS)
