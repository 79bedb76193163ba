"""The s8 × s8 → s32 convolution of the int8 encoder convs
(``models/quantize.py::QuantConv``), with its dequantizing epilogue.

``int8_conv2d(x_q, w_q, scale, stride, pad_top, pad_bottom, pad_left,
pad_right, out_dtype)`` takes x_q int8 (N, H, W, C), w_q int8 (O, k, k, C)
(OHWI) and a float32 (O,) ``scale``, zero-pads x_q by the given rows and
columns, and returns (N, H_out, W_out, O): the int32 sums where
``out_dtype`` is ``torch.int32``, else ``float32(sum) · scale[o]`` rounded
into ``out_dtype``, the JAX package's ``(y.astype(f32) · (s_x · s_w))
.astype(dtype)`` (``models/quantize.py:92-96``) in the same order. It is the
``torch.library`` custom op ``bas_torch::int8_conv2d``, so that
``torch.export`` keeps it as one node of a sealed program.

- On a CPU tensor the op is the plain version ``int8_conv2d_reference``:
  the sums exactly, by a float64 convolution of the int8 values (products
  below 2^14 and sums below 2^53; never float32, whose 24 bits the
  flagship's sums of up to 127² · 1728 pass).
- On a CUDA tensor a 1 × 1 conv at stride 1 without padding is one
  ``torch._int_mm`` (``int_mm_takes``: M > 16, C and O multiples of 8),
  counted in ``INT_MM``, then the same dequantization in PyTorch; every
  other shape (the k × k convs, and a 1 × 1 that ``_int_mm`` refuses) is
  the hand-written kernel ``csrc/int8_conv.cu`` (``int8_conv2d_cuda``), to
  which the route brings C up to a multiple of 16 (zero channels) and x_q
  contiguous and 16-byte aligned. Nothing falls back to a float conv.

Inference only: the op registers no backward, so a gradient through it
raises (the JAX package's gradient through ``QuantConv`` is zero at the
rounding and flows through the scale's max).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle

KERNEL = CudaKernel(
    "int8_conv", "int8_conv_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 14 + [ctypes.c_void_p],
)
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
_MAX_GRID_X = 2**31 - 1
_MAX_GRID_Y = 65535
_TILE_H, _TILE_W = 4, 32  # csrc/int8_conv.cu's output tile


class CallCount:
    """Calls of a library route, counted as ``CudaKernel`` counts launches."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def reset_counts(self) -> None:
        self.launches = 0


INT_MM = CallCount("int_mm")


def channel_tile(o: int) -> int:
    """The kernel's output channels per block: 16, 32 or 64."""
    return 16 if o <= 16 else 32 if o <= 32 else 64


def out_size(size: int, kernel: int, stride: int, before: int, after: int) -> int:
    return (size + before + after - kernel) // stride + 1


def _check(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, stride: int,
           pads: tuple[int, int, int, int], out_dtype: torch.dtype) -> tuple[int, int]:
    """Validate the op's arguments; return the output's (H, W)."""
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise ValueError(f"int8_conv2d expects int8 (N, H, W, C), got {x_q.dtype} "
                         f"{tuple(x_q.shape)}")
    o, kh, kw, c = w_q.shape if w_q.dim() == 4 else (0, 0, 0, 0)
    if w_q.dtype != torch.int8 or kh != kw or kh < 1 or c != x_q.shape[-1]:
        raise ValueError(f"int8_conv2d expects int8 (O, k, k, {x_q.shape[-1]}) weights, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (o,):
        raise ValueError(f"int8_conv2d expects a float32 ({o},) scale, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"int8_conv2d writes {sorted(map(str, _OUT_CODE))}, not {out_dtype}")
    if stride < 1 or min(pads) < 0:
        raise ValueError(f"int8_conv2d needs stride ≥ 1 and pads ≥ 0, got {stride} {pads}")
    pt, pb, pl, pr = pads
    ho = out_size(x_q.shape[1], kh, stride, pt, pb)
    wo = out_size(x_q.shape[2], kh, stride, pl, pr)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv2d: no output for input {tuple(x_q.shape)}, kernel {kh}, "
                         f"stride {stride}, pads {pads}")
    return ho, wo


def dequantize(sums: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """int32 sums (…, O) → ``float32(sums) · scale`` rounded into
    ``out_dtype``; the sums themselves for ``torch.int32``."""
    if out_dtype == torch.int32:
        return sums
    return (sums.to(torch.float32) * scale).to(out_dtype)


def int8_conv2d_sums_reference(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                               pads: tuple[int, int, int, int]) -> torch.Tensor:
    """Plain version of the s8 product: (N, H_out, W_out, O) int32 sums of
    the zero-padded conv, exact (float64 over the int8 values; on a CUDA
    tensor with cuDNN off, so that the sum is the native im2col product's,
    never an FFT or Winograd transform)."""
    pt, pb, pl, pr = pads
    x = F.pad(x_q.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    w = w_q.permute(0, 3, 1, 2).to(torch.float64)
    off = torch.backends.cudnn.flags(enabled=False) if x.is_cuda else contextlib.nullcontext()
    with off:
        y = F.conv2d(x, w, stride=stride)
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv2d_reference(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                          stride: int, pad_top: int, pad_bottom: int, pad_left: int,
                          pad_right: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``int8_conv2d``: the exact sums, then
    ``dequantize``."""
    pads = (pad_top, pad_bottom, pad_left, pad_right)
    _check(x_q, w_q, scale, stride, pads, out_dtype)
    return dequantize(int8_conv2d_sums_reference(x_q, w_q, stride, pads), scale, out_dtype)


def int_mm_takes(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, pads) -> bool:
    """Whether a conv is one ``torch._int_mm``: 1 × 1 at stride 1 without
    padding, and the product (M, C) × (C, O) within ``_int_mm``'s rules on
    CUDA (M > 16; C and O positive multiples of 8)."""
    o, k, _, c = w_q.shape
    m = x_q.shape[0] * x_q.shape[1] * x_q.shape[2]
    return (k == 1 and stride == 1 and not any(pads) and m > 16 and c % 8 == 0
            and o % 8 == 0 and c > 0 and o > 0)


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The 1 × 1 route: (N, H, W, C) x_q times (O, 1, 1, C) w_q by
    ``torch._int_mm`` (int32 sums), then ``dequantize``."""
    n, h, w, c = x_q.shape
    o = w_q.shape[0]
    sums = torch._int_mm(x_q.reshape(n * h * w, c), w_q.reshape(o, c).t())
    INT_MM.launches += 1
    return dequantize(sums, scale, out_dtype).reshape(n, h, w, o)


def int8_conv2d_cuda(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, stride: int,
                     pads: tuple[int, int, int, int], out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/int8_conv.cu`` on CUDA tensors: x_q contiguous,
    16-byte aligned, C a multiple of 16. The batch and the channel tiles are
    sliced where the grid would pass its limits (one launch per slice)."""
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv2d_cuda needs a CUDA tensor, got {x_q.device}")
    ho, wo = _check(x_q, w_q, scale, stride, pads, out_dtype)
    if w_q.device != x_q.device or scale.device != x_q.device:
        raise ValueError("int8_conv2d kernel: weights and scale must lie on x's device")
    n, h, w, c = x_q.shape
    o, k = w_q.shape[:2]
    if c % 16 or not (x_q.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_conv2d kernel needs contiguous tensors and C a multiple of 16")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_conv2d kernel stages 16-byte copies: x and w must be 16-byte "
                         "aligned")
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=x_q.device)
    tiles = -(-ho // _TILE_H) * -(-wo // _TILE_W)
    per = max(1, _MAX_GRID_X // tiles)  # images per launch
    o_tiles = -(-o // channel_tile(o))
    code, itemsize = _OUT_CODE[out_dtype], out.element_size()
    pt, _, pl, _ = pads
    with torch.cuda.device(x_q.device):
        stream = stream_handle(x_q)
        for b0 in range(0, n, per):
            nb = min(per, n - b0)
            for t0 in range(0, o_tiles, _MAX_GRID_Y):
                KERNEL.launch(x_q.data_ptr() + b0 * h * w * c, w_q.data_ptr(), scale.data_ptr(),
                              out.data_ptr() + b0 * ho * wo * o * itemsize, nb, h, w, c, o, k,
                              stride, pt, pl, ho, wo, code, t0,
                              min(_MAX_GRID_Y, o_tiles - t0), stream)
    return out


@torch.library.custom_op("bas_torch::int8_conv2d", mutates_args=(), device_types="cpu")
def int8_conv2d_op(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, stride: int,
                   pad_top: int, pad_bottom: int, pad_left: int, pad_right: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """``bas_torch::int8_conv2d``, the registered op: the plain version on
    a CPU tensor; on a CUDA tensor ``_int_mm`` or the kernel, through
    ``_int8_conv2d_cuda_route``."""
    return int8_conv2d_reference(x_q, w_q, scale, stride, pad_top, pad_bottom, pad_left,
                                 pad_right, out_dtype)


@int8_conv2d_op.register_kernel("cuda")
def _int8_conv2d_cuda_route(x_q, w_q, scale, stride, pad_top, pad_bottom, pad_left,
                            pad_right, out_dtype):
    """A CUDA tensor's route: ``_int_mm`` for the 1 × 1 shapes it takes,
    else the kernel, with C padded to a multiple of 16 (zero channels, which
    add nothing to the sums) and x_q made contiguous and aligned."""
    pads = (pad_top, pad_bottom, pad_left, pad_right)
    _check(x_q, w_q, scale, stride, pads, out_dtype)
    if int_mm_takes(x_q, w_q, stride, pads):
        return int8_matmul_cuda(x_q.contiguous(), w_q.contiguous(), scale, out_dtype)
    c = x_q.shape[-1]
    if c % 16:
        x_q = F.pad(x_q, (0, -c % 16))
        w_q = F.pad(w_q, (0, -c % 16))
    if not x_q.is_contiguous() or x_q.data_ptr() % 16:
        x_q = x_q.clone(memory_format=torch.contiguous_format)
    if not w_q.is_contiguous() or w_q.data_ptr() % 16:
        w_q = w_q.clone(memory_format=torch.contiguous_format)
    return int8_conv2d_cuda(x_q, w_q, scale.contiguous(), stride, pads, out_dtype)


@int8_conv2d_op.register_fake
def _int8_conv2d_fake(x_q, w_q, scale, stride, pad_top, pad_bottom, pad_left, pad_right,
                      out_dtype):
    ho, wo = _check(x_q, w_q, scale, stride, (pad_top, pad_bottom, pad_left, pad_right),
                    out_dtype)
    return x_q.new_empty((x_q.shape[0], ho, wo, w_q.shape[0]), dtype=out_dtype)


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, stride: int,
                pads: tuple[int, int, int, int], out_dtype: torch.dtype) -> torch.Tensor:
    """The s8 conv of x_q (N, H, W, C) with w_q (O, k, k, C) and ``pads``
    (top, bottom, left, right), dequantized by ``scale`` into ``out_dtype``
    (module docstring): ``bas_torch::int8_conv2d``."""
    return int8_conv2d_op(x_q, w_q, scale, stride, *pads, out_dtype)
