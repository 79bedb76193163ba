"""Affine image warping as two 1D bilinear resample passes.

Port of the JAX package's ``ops/warp.py`` and its TPU kernel
``ops/pallas_warp.py``. An affine inverse map decomposes exactly into a
horizontal pass (per input row, the source column is affine in the output
column) followed by a vertical pass (per column, the source row is affine in
the output row). Each pass samples ``img[.., scale·t + offset]`` bilinearly
with zeros outside, where the offset is taken at the center of each block of
``block`` rows (or columns), as in the JAX package.

``resample_last_axis`` runs the H pass and ``resample_columns`` the V pass
over a batch of N images, both through the ``torch.library`` custom op
``bas_torch::warp_resample``. On a CUDA tensor each is one launch of the
hand-written kernel ``csrc/warp.cu`` (the V pass reads down the columns, so it
needs no transposes), which reads each block's center offset itself; on a
CPU tensor they are the plain version, the JAX package's
interpolation-matrix formula (``resample_last_axis_reference``).
``affine_warp`` composes them for (N, H, W) images and (N, 3, 3) inverse maps.
The kernel moves 16-byte vectors where ``wide_path`` allows it and one
element per thread otherwise.

``precision="bfloat16"`` rounds the image and the interpolation weights to
bf16 and sums in float32; ``"highest"`` runs in float32. A bf16 image rounds
its weights in either mode, as the JAX matrix takes the image's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle

KERNEL = CudaKernel(
    "warp", "warp_resample",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PRECISIONS = ("highest", "bfloat16")
_SMEM_ONE_BLOCK = 227 * 1024  # an H-pass block stages at least one whole row


def wide_path(img: torch.Tensor, block: int, axis: int) -> bool:
    """Whether ``csrc/warp.cu`` takes its 16-byte path for a contiguous
    (N, H, W) ``img``: rows of whole 16-byte vectors from a 16-byte aligned
    start; the V pass (axis 1) also needs whole vectors in each column
    block, the H pass (axis 2) a row that fits one block's shared memory."""
    vec = 16 // img.element_size()
    w = img.shape[2]
    if w % vec or img.data_ptr() % 16:
        return False
    if axis == 1:
        return block % vec == 0
    return w * img.element_size() <= _SMEM_ONE_BLOCK


def block_center_offsets(offsets: torch.Tensor, block: int) -> torch.Tensor:
    """(N, L) per-row offsets → (N, ceil(L/block)) offsets at each block's
    center row; rows past L take row L−1's offset (the JAX edge padding)."""
    length = offsets.shape[1]
    nb = -(-length // block)
    centers = (torch.arange(nb, device=offsets.device) * block + block // 2).clamp(max=length - 1)
    return offsets[:, centers].float().contiguous()


def _check(img: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
           length: int, block: int, precision: str) -> None:
    if img.dim() != 3:
        raise ValueError(f"resample expects (N, H, W) images, got shape {tuple(img.shape)}")
    n = img.shape[0]
    if tuple(scale.shape) != (n,) or tuple(offsets.shape) != (n, length):
        raise ValueError(f"resample expects scale ({n},) and offsets ({n}, {length}), "
                         f"got {tuple(scale.shape)} and {tuple(offsets.shape)}")
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")


def interpolation_matrices(scale: torch.Tensor, off_c: torch.Tensor, w: int) -> torch.Tensor:
    """One image's (nb, W_in, W_out) float32 bilinear interpolation
    matrices: column x of block b holds the weights of the two taps around
    ``scale·x + off_c[b]``, zero for a tap outside [0, W)."""
    cols = torch.arange(w, device=off_c.device)
    xs = torch.arange(w, device=off_c.device, dtype=torch.float32)
    grid = scale.float() * xs[None, :] + off_c[:, None]  # (nb, W_out)
    j0f = torch.floor(grid)
    f = grid - j0f
    j0 = j0f.clamp(-2, w).long()
    valid0 = (j0 >= 0) & (j0 <= w - 1)
    valid1 = (j0 + 1 >= 0) & (j0 + 1 <= w - 1)
    j0c = j0.clamp(0, w - 1)
    j1c = (j0 + 1).clamp(0, w - 1)
    return ((cols[None, :, None] == j0c[:, None, :]) * ((1.0 - f) * valid0)[:, None, :]
            + (cols[None, :, None] == j1c[:, None, :]) * (f * valid1)[:, None, :])


def resample_last_axis_reference(img: torch.Tensor, scale: torch.Tensor,
                                 offsets: torch.Tensor, block: int = 32,
                                 precision: str = "highest") -> torch.Tensor:
    """Plain version, the JAX package's ``_resample_last_axis`` batched over
    N: per row block a (W_in, W_out) bilinear interpolation matrix, then the
    block times the matrix with float32 sums. Images are done one at a time
    to bound the matrices' memory."""
    _check(img, scale, offsets, img.shape[1], block, precision)
    n, h, w = img.shape
    hpad = -(-h // block) * block
    nb = hpad // block
    off_c = block_center_offsets(offsets, block)
    rounded = precision == "bfloat16" or img.dtype == torch.bfloat16
    out = torch.empty_like(img)
    for i in range(n):
        m = interpolation_matrices(scale[i], off_c[i], w)
        blocks = torch.zeros((hpad, w), dtype=img.dtype, device=img.device)
        blocks[:h] = img[i]
        blocks = blocks.reshape(nb, block, w)
        if rounded:  # the matrix and the block in bf16, products summed in f32
            m = m.to(torch.bfloat16)
            blocks = blocks.to(torch.bfloat16)
        res = torch.bmm(blocks.float(), m.float())  # (nb, block, W_out)
        out[i] = res.reshape(hpad, w)[:h].to(img.dtype)
    return out


def _resample_cuda(img: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
                   block: int, precision: str, axis: int) -> torch.Tensor:
    if img.device.type != "cuda":
        raise ValueError(f"the warp kernel needs a CUDA tensor, got {img.device}")
    if img.dtype not in _DTYPE_CODE:
        raise ValueError(f"the warp kernel takes float32/bfloat16/float16, got {img.dtype}")
    if scale.device != img.device or offsets.device != img.device:
        raise ValueError("scale and offsets must lie on the image's device")
    n, h, w = img.shape
    if min(n, h, w) == 0:
        raise ValueError(f"the warp kernel got an empty tensor {tuple(img.shape)}")
    img = img.contiguous()
    scale = scale.float().contiguous()
    offsets = offsets.float().contiguous()
    out = torch.empty_like(img)
    bf16_math = int(precision == "bfloat16" or img.dtype == torch.bfloat16)
    with torch.cuda.device(img.device):
        KERNEL.launch(img.data_ptr(), out.data_ptr(), scale.data_ptr(), offsets.data_ptr(),
                      n, h, w, block, axis, _DTYPE_CODE[img.dtype], bf16_math,
                      int(wide_path(img, block, axis)), stream_handle(img),
                      tag="H" if axis == 2 else "V")
    return out


@torch.library.custom_op("bas_torch::warp_resample", mutates_args=(), device_types="cpu")
def warp_resample_op(img: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
                     block: int, precision: str, axis: int) -> torch.Tensor:
    """``bas_torch::warp_resample``, the registered op: one resample pass of
    (N, H, W) images, the H pass along rows (``axis`` 2) or the V pass down
    columns (``axis`` 1). The plain version on a CPU tensor, the kernel on a
    CUDA tensor (``_resample_cuda``)."""
    if axis == 2:
        return resample_last_axis_reference(img, scale, offsets, block, precision)
    out_t = resample_last_axis_reference(img.transpose(1, 2), scale, offsets, block, precision)
    return out_t.transpose(1, 2).contiguous()


warp_resample_op.register_kernel("cuda", _resample_cuda)


@warp_resample_op.register_fake
def _warp_resample_fake(img: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
                        block: int, precision: str, axis: int) -> torch.Tensor:
    return img.new_empty(img.shape)


def resample_last_axis(img: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
                       block: int = 32, precision: str = "highest") -> torch.Tensor:
    """H pass: ``out[n, r, x]`` = bilinear sample of ``img[n, r, scale[n]·x +
    offsets[n, r]]``, zeros outside, the offset taken at each ``block`` of
    rows' center row. img (N, H, W), scale (N,), offsets (N, H). Calls
    ``bas_torch::warp_resample``: a CUDA tensor goes through the kernel (or
    raises), a CPU tensor through the plain version."""
    _check(img, scale, offsets, img.shape[1], block, precision)
    return warp_resample_op(img, scale, offsets, block, precision, 2)


def resample_columns(img: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
                     block: int = 32, precision: str = "highest") -> torch.Tensor:
    """V pass: ``resample_last_axis`` of the transposed image, transposed
    back. img (N, H, W), scale (N,), offsets (N, W), blocks of columns."""
    _check(img, scale, offsets, img.shape[2], block, precision)
    return warp_resample_op(img, scale, offsets, block, precision, 1)


def affine_warp(img: torch.Tensor, inv_mat: torch.Tensor, block: int = 32,
                precision: str = "highest") -> torch.Tensor:
    """Warp (N, H, W) images by per-image inverse maps ``inv_mat`` (N, 3, 3),
    output → source coordinates on (x, y, 1): bilinear, zeros outside. The
    H pass, then the V pass (the JAX ``affine_warp_matmul`` per image)."""
    n, h, w = img.shape
    inv_mat = inv_mat.to(device=img.device, dtype=torch.float32)
    a11, a12, b1 = inv_mat[:, 0, 0], inv_mat[:, 0, 1], inv_mat[:, 0, 2]
    a21, a22, b2 = inv_mat[:, 1, 0], inv_mat[:, 1, 1], inv_mat[:, 1, 2]
    # guard the two-pass degenerate direction (|a22| ≈ 0: ±90° rotations)
    guard = torch.where(a22 < 0, -1e-3, 1e-3).to(a22.dtype)
    a22 = torch.where(a22.abs() < 1e-3, guard, a22)

    # H pass over input rows r: u(x_out, r) = p·x_out + q·r + c
    p = a11 - a12 * a21 / a22
    q = a12 / a22
    c = b1 - a12 * b2 / a22
    rows = torch.arange(h, dtype=torch.float32, device=img.device)
    tmp = resample_last_axis(img.contiguous(), p, q[:, None] * rows[None, :] + c[:, None],
                             block, precision)

    # V pass over columns x: v(y_out, x) = a22·y_out + a21·x + b2
    cols = torch.arange(w, dtype=torch.float32, device=img.device)
    return resample_columns(tmp, a22, a21[:, None] * cols[None, :] + b2[:, None],
                            block, precision)
