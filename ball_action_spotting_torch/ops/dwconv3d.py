"""Depthwise 3×3×3 SAME convolution over channels-last video features.

Port of the JAX package's ``ops/pallas_dwconv3d.py``. ``dwconv3d`` takes
x (N, T, H, W, C) and a kernel in the JAX layout (3, 3, 3, 1, C) and returns
(N, T, H, W, C) in x's dtype, summing the 27 taps in float32. On a CUDA
tensor it is the hand-written kernel ``csrc/dwconv3d.cu``; on a CPU tensor
the plain version ``dwconv3d_reference``. Inference only: the kernel has no
backward, as in the JAX package.

The kernel walks T inside each block over a ring of three staged input
slices. It stages with 16-byte copies where C·itemsize is a multiple of 16
and x is 16-byte aligned, and with one channel pair per copy otherwise; it
takes any even C and an x aligned to a channel pair, and slices N itself.
``dwconv3d`` brings every other CUDA tensor to it: a non-contiguous or
misaligned x is copied, and an odd C gets one zero channel (and one zero
tap column), sliced off the output. A width whose three staged rows do not
fit a block's shared memory (``kernel_stages``) goes to
``dwconv3d_grouped_conv`` instead, as the JAX package goes to its lax conv
when a slice does not fit VMEM.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle

KERNEL = CudaKernel(
    "dwconv3d", "dwconv3d_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# csrc/dwconv3d.cu's staging arithmetic (launch_tiled): a ring of 3 slots of
# (rows + 2) halo rows × W positions × 32 channel pairs, in one block of at
# most 227 KB of shared memory
_SLOTS, _LANES, _SMEM_ONE_BLOCK = 3, 32, 227 * 1024


def kernel_stages(w: int, dtype: torch.dtype) -> bool:
    """Whether the kernel can stage a width-``w`` input of ``dtype``: one
    output row (three halo rows) of the ring must fit one block's shared
    memory. Bf16 and fp16 fit up to W 201, float32 up to W 100."""
    row_bytes = _SLOTS * w * _LANES * 2 * dtype.itemsize
    return _SMEM_ONE_BLOCK // row_bytes - 2 >= 1


def _check_kernel_shape(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"dwconv3d expects (N, T, H, W, C), got shape {tuple(x.shape)}")
    if tuple(kernel.shape) != (3, 3, 3, 1, x.shape[-1]):
        raise ValueError(
            f"dwconv3d kernel must be (3, 3, 3, 1, {x.shape[-1]}), got {tuple(kernel.shape)}")


def dwconv3d_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain version: an explicit 27-tap shifted sum in float32 over the
    zero-padded input, in the TPU kernel's tap order (dt, dh, dw)."""
    _check_kernel_shape(x, kernel)
    _, t, h, w, _ = x.shape
    k = kernel[:, :, :, 0, :].float()  # (3, 3, 3, C)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))  # zero SAME pad of T, H, W
    acc = None
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                term = xp[:, dt:dt + t, dh:dh + h, dw:dw + w] * k[dt, dh, dw]
                acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def dwconv3d_cuda(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/dwconv3d.cu`` on a CUDA (N, T, H, W, C) tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"dwconv3d_cuda needs a CUDA tensor, got {x.device}")
    _check_kernel_shape(x, kernel)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dwconv3d kernel takes float32/bfloat16/float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dwconv3d kernel needs a contiguous channels-last tensor")
    if kernel.device != x.device:
        raise ValueError("dwconv3d kernel weights must lie on x's device")
    n, t, h, w, c = x.shape
    if min(n, t, h, w, c) == 0:
        raise ValueError(f"dwconv3d kernel got an empty tensor {tuple(x.shape)}")
    if c % 2 or x.data_ptr() % (2 * x.element_size()):
        raise ValueError("dwconv3d kernel reads channel pairs: C must be even and "
                         "x aligned to a pair")
    if not kernel_stages(w, x.dtype):
        raise ValueError(f"dwconv3d kernel cannot stage W {w} in {x.dtype}")
    taps = kernel.reshape(27, c).float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), taps.data_ptr(), out.data_ptr(), n, t, h, w, c,
                      _DTYPE_CODE[x.dtype], stream_handle(x))
    return out


def dwconv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 3×3×3 SAME conv: x (N, T, H, W, C), kernel (3, 3, 3, 1, C)
    → (N, T, H, W, C) in x's dtype. A CUDA tensor goes through the kernel
    (or through the grouped conv where the kernel cannot stage W); a CPU
    tensor through the plain version."""
    if x.device.type != "cuda":
        return dwconv3d_reference(x, kernel)
    _check_kernel_shape(x, kernel)
    if not kernel_stages(x.shape[3], x.dtype):
        return dwconv3d_grouped_conv(x, kernel)
    c = x.shape[-1]
    if c % 2:  # one zero channel makes the pairs whole; its output is dropped
        x = F.pad(x, (0, 1))
        kernel = F.pad(kernel, (0, 1))
    elif not x.is_contiguous():
        x = x.contiguous()
    elif x.data_ptr() % (2 * x.element_size()):
        x = x.clone()  # a fresh allocation starts on a pair
    out = dwconv3d_cuda(x, kernel)
    return out[..., :c].contiguous() if c % 2 else out


def dwconv3d_grouped_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``F.conv3d(groups=C)`` on the same layout: the default (non-kernel)
    path of ``DepthwiseConv3d``, the counterpart of JAX's lax grouped conv."""
    _check_kernel_shape(x, kernel)
    c = x.shape[-1]
    weight = kernel.permute(4, 3, 0, 1, 2).to(x.dtype)  # (C, 1, 3, 3, 3)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, padding=1, groups=c)
    return y.permute(0, 2, 3, 4, 1).contiguous()
