"""Port warp against the JAX package: the plain resample (the CPU path of
``ops/warp.py``) against JAX's XLA formula ``_resample_last_axis`` and the
Pallas kernel in interpret mode, and ``affine_warp`` against
``affine_warp_clip``. The kernel ``csrc/warp.cu`` is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: float32 atol 1e-5 (two-tap sums in another order); bfloat16
atol 4e-3, the documented bound of the bf16 mode (``warp.py:39-43``) on
[0, 1] images, since the two frameworks round the bf16 products' sums at
other places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.ops.pallas_warp import resample_last_axis_pallas
from ball_action_spotting_tpu.ops.warp import _resample_last_axis, affine_warp_clip
from ball_action_spotting_torch.ops import KERNELS
from ball_action_spotting_torch.ops.augment import crop_matrix, hflip_matrix, rotation_scale_about
from ball_action_spotting_torch.ops.warp import (
    affine_warp,
    block_center_offsets,
    resample_columns,
    resample_last_axis,
    wide_path,
)

ATOL = {"highest": 1e-5, "bfloat16": 4e-3}

# (rows, width, scale, offsets, block): scale with shear (offsets vary by
# row), identity, far out of range, rows not a multiple of the block
CASES = {
    "scale_shear": (40, 128, 1.03, np.linspace(-3.0, 5.0, 40), 8),
    "identity": (37, 128, 1.0, np.zeros(37), 8),
    "out_of_range": (37, 128, 1.0, np.full(37, 500.0), 8),
    "ragged_rows": (37, 96, 0.97, np.linspace(2.0, -4.0, 37), 8),
}


def _inputs(case, n=3, seed=0):
    h, w, scale, offsets, block = CASES[case]
    rng = np.random.default_rng(seed)
    img = rng.random((n, h, w)).astype(np.float32)
    step = 0.0 if case == "identity" else 1.0  # each image its own warp
    scales = (scale * (1.0 + 0.01 * step * np.arange(n))).astype(np.float32)
    offs = (offsets[None, :] + step * 0.3 * np.arange(n)[:, None]).astype(np.float32)
    return img, scales, offs, block


@pytest.mark.parametrize("precision", ["highest", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resample_matches_jax_xla_and_pallas(case, precision):
    img, scales, offs, block = _inputs(case)
    out = resample_last_axis(torch.from_numpy(img), torch.from_numpy(scales),
                             torch.from_numpy(offs), block, precision).numpy()
    for i in range(img.shape[0]):
        args = (jnp.asarray(img[i]), jnp.float32(scales[i]), jnp.asarray(offs[i]))
        xla = _resample_last_axis(*args, block, precision)
        pallas = resample_last_axis_pallas(*args, block=block, interpret=True,
                                           precision=precision)
        np.testing.assert_allclose(out[i], np.asarray(xla), atol=ATOL[precision])
        np.testing.assert_allclose(out[i], np.asarray(pallas), atol=ATOL[precision])
    if case == "identity" and precision == "highest":
        np.testing.assert_array_equal(out, img)
    if case == "out_of_range":
        assert np.abs(out).max() == 0.0


def test_bf16_image_keeps_its_dtype_and_rounds_like_jax():
    img, scales, offs, block = _inputs("scale_shear")
    img16 = torch.from_numpy(img).bfloat16()
    out = resample_last_axis(img16, torch.from_numpy(scales), torch.from_numpy(offs), block)
    assert out.dtype == torch.bfloat16
    expected = _resample_last_axis(jnp.asarray(img16[0].float().numpy()).astype(jnp.bfloat16),
                                   jnp.float32(scales[0]), jnp.asarray(offs[0]), block)
    np.testing.assert_allclose(out[0].float().numpy(), np.asarray(expected, np.float32),
                               atol=ATOL["bfloat16"])


def test_resample_columns_is_the_transposed_pass():
    img, scales, offs, block = _inputs("ragged_rows")
    img_t = np.ascontiguousarray(img.transpose(0, 2, 1))  # (n, 96, 37): columns of 96 rows
    out = resample_columns(torch.from_numpy(img_t), torch.from_numpy(scales),
                           torch.from_numpy(offs), block).numpy()
    for i in range(img.shape[0]):
        expected = _resample_last_axis(jnp.asarray(img[i]), jnp.float32(scales[i]),
                                       jnp.asarray(offs[i]), block)
        np.testing.assert_allclose(out[i], np.asarray(expected).T, atol=ATOL["highest"])


def test_block_center_offsets_clamp_to_the_last_row():
    offs = torch.arange(37, dtype=torch.float32)[None]
    # centers of blocks of 8: rows 4, 12, 20, 28, then 36 (row 36 exists)
    assert block_center_offsets(offs, 8).tolist() == [[4.0, 12.0, 20.0, 28.0, 36.0]]
    # 35 rows: the last block's center (36) is edge padding → row 34
    assert block_center_offsets(offs[:, :35], 8).tolist() == [[4.0, 12.0, 20.0, 28.0, 34.0]]


def _inverse_maps(h, w):
    """hflip, a 5° rotation about the center and a crop, as inverse maps."""
    one = torch.ones(())
    fwd = torch.stack([
        hflip_matrix(float(w), torch.tensor(True)),
        rotation_scale_about(one * (w - 1) / 2, one * (h - 1) / 2, torch.tensor(5.0), one, one),
        crop_matrix(torch.tensor(6.0), torch.tensor(3.0), torch.tensor(0.9 * w),
                    torch.tensor(0.92 * h), float(w), float(h)),
    ])
    return torch.linalg.inv(fwd)


@pytest.mark.parametrize("precision", ["highest", "bfloat16"])
def test_affine_warp_matches_jax(precision):
    h, w = 40, 72
    inv = _inverse_maps(h, w)
    img = np.random.default_rng(3).random((3, h, w)).astype(np.float32)
    out = affine_warp(torch.from_numpy(img), inv, precision=precision).numpy()
    expected = affine_warp_clip(jnp.asarray(img), jnp.asarray(inv.numpy()),
                                precision=precision)
    np.testing.assert_allclose(out, np.asarray(expected), atol=ATOL[precision])
    # hflip is exact: column x comes from column W-1-x
    if precision == "highest":
        np.testing.assert_array_equal(out[0], img[0][:, ::-1])


def test_wrappers_validate_inputs_and_count_no_cpu_launch():
    img = torch.rand(2, 8, 16)
    for kernel in KERNELS:
        kernel.launches = 0
    resample_last_axis(img, torch.ones(2), torch.zeros(2, 8))
    resample_columns(img, torch.ones(2), torch.zeros(2, 16))
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    with pytest.raises(ValueError):
        resample_last_axis(img, torch.ones(2), torch.zeros(2, 16))  # offsets per row
    with pytest.raises(ValueError):
        resample_last_axis(img[0], torch.ones(1), torch.zeros(1, 16))  # rank
    with pytest.raises(ValueError):
        resample_last_axis(img, torch.ones(2), torch.zeros(2, 8), precision="fast")


# (N, H, W), dtype, block, pass axis (2 = H, 1 = V), offset in elements,
# whether csrc/warp.cu takes its 16-byte path
@pytest.mark.parametrize("shape,dtype,block,axis,offset,wide", [
    ((60, 736, 1280), torch.bfloat16, 32, 2, 0, True),   # the train step's H pass
    ((60, 736, 1280), torch.bfloat16, 32, 1, 0, True),   # ... and V pass
    ((60, 736, 1280), torch.float32, 32, 1, 0, True),
    ((2, 5, 37), torch.bfloat16, 32, 2, 0, False),       # W 37: not whole vectors
    ((2, 5, 37), torch.float32, 32, 1, 0, False),
    ((2, 5, 64), torch.bfloat16, 32, 2, 1, False),       # a misaligned view
    ((2, 5, 64), torch.float16, 32, 1, 1, False),
    ((2, 5, 64), torch.bfloat16, 7, 1, 0, False),        # V: block 7 splits a vector
    ((2, 5, 64), torch.bfloat16, 7, 2, 0, True),         # H: any block
    ((2, 5, 64), torch.float32, 4, 1, 0, True),
    ((1, 1, 65536), torch.float32, 32, 2, 0, False),     # H: a row past 227 KB
])
def test_wide_path_predicate(shape, dtype, block, axis, offset, wide):
    flat = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    assert wide_path(flat[offset:].view(shape), block, axis) is wide


def test_fp16_image_matches_jax():
    """An fp16 image keeps its dtype; JAX rounds its interpolation matrix to
    fp16 and the port keeps it in float32, within the bf16 mode's bound."""
    img, scales, offs, block = _inputs("scale_shear")
    img16 = torch.from_numpy(img).half()
    out = resample_last_axis(img16, torch.from_numpy(scales), torch.from_numpy(offs), block)
    assert out.dtype == torch.float16
    for i in range(img.shape[0]):
        expected = _resample_last_axis(jnp.asarray(img16[i].float().numpy()).astype(jnp.float16),
                                       jnp.float32(scales[i]), jnp.asarray(offs[i]), block)
        np.testing.assert_allclose(out[i].float().numpy(), np.asarray(expected, np.float32),
                                   atol=ATOL["bfloat16"])
