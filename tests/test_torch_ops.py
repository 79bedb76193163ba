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
)
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_cuda
from ball_action_spotting_torch.ops.warp import resample_last_axis

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


# the last two at the CUDA kernel's tiling edges: one slice of 23 rows in
# ragged row tiles, and C = 6, which the kernel stages with narrow copies
@pytest.mark.parametrize("shape", [(2, 5, 7, 10, 32), (1, 3, 4, 6, 64), (1, 1, 3, 3, 8),
                                   (1, 1, 23, 40, 16), (1, 5, 23, 40, 6)])
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
