"""The int8 convolution of the encoder's quantized convs
(``models/quantize.py::QuantConv``): quantize the input, the s8 × s8 → s32
sum, dequantize, in one op.

``int8_conv2d(x, s_x, w_q, s_w, stride, pad_top, pad_bottom, pad_left,
pad_right, out_dtype)`` takes x (N, H, W, C) in the compute dtype (float32,
bfloat16 or float16), the float32 0-dim activation scale ``s_x``, w_q int8
(O, k, k, C) (OHWI) and its float32 (O,) scale ``s_w``; it quantizes x as
``quantize`` does, ``clip(round(float32(x) / s_x), ±127)``, zero-pads it by
the given rows and columns, and returns (N, H_out, W_out, O): the int32
sums where ``out_dtype`` is ``torch.int32``, else ``float32(sum) · (s_x ·
s_w[o])`` rounded into ``out_dtype``, the JAX package's ``(y.astype(f32) ·
(s_x · s_w)).astype(dtype)`` (``models/quantize.py:92-96``) in the same
order. It is the ``torch.library`` custom op ``bas_torch::int8_conv2d``, so
that ``torch.export`` keeps it as one node of a sealed program.

- On a CPU tensor the op is the plain version ``int8_conv2d_reference``:
  ``quantize``, the sums exactly (``int8_conv2d_sums_reference``, a float64
  convolution of the int8 values: products below 2^14 and sums below 2^53;
  never float32, whose 24 bits the flagship's sums of up to 127² · 1728
  pass), then ``dequantize``.
- On a CUDA tensor it is one launch of a hand-written kernel, which
  quantizes its compute-dtype input on the way to the s8 product and
  dequantizes in its epilogue, chosen by the shape before the launch
  (``_int8_conv2d_cuda_route``): ``GEMM_KERNEL`` (``csrc/int8_gemm.cu``,
  ``int8_gemm_forward``: TMA ring, wgmma) for a 1 × 1 conv at stride 1
  without padding whose rows TMA can read (``gemm_takes``), else
  ``CONV3X3_KERNEL`` (``csrc/int8_conv3x3.cu``, ``int8_conv3x3_forward``:
  TMA halo boxes, wgmma) for a 3 × 3 conv it takes (``conv3x3_takes``),
  else ``KERNEL`` (``csrc/int8_conv.cu``, ``int8_conv_forward``) for every
  other shape. Each counts its launches. A kernel that refuses a shape its
  predicate gave it raises; nothing falls back to another kernel, to
  separate passes or to a float conv.

The gradient is JAX's (``models/quantize.py:83-96`` under ``jax.grad``):
zero through the rounding, so none for x and w_q along the s8 product, and
``Σ g · float32(sums) · s_w[o]`` for ``s_x``, ``Σ g · float32(sums) · s_x``
for ``s_w[o]`` through the dequantizing product, the sums from a second
call of the op with ``out_dtype=torch.int32`` (on the card, the kernels).
``QuantConv`` takes its scales differentiably where grad is enabled, so
that the gradient reaches x and the weight through the maxima.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
# int8_conv_forward(x, s_x, w_q, s_w, out, n, h, w, c, o, k, s, pt, pl, ho,
# wo, in_code, out_code, stream)
KERNEL = CudaKernel("int8_conv", "int8_conv_forward", [_P] * 5 + [_I] * 13 + [_P])
# int8_gemm_forward(x, s_x, w_q, s_w, out, m, c, o, in_code, out_code, stream)
GEMM_KERNEL = CudaKernel("int8_gemm", "int8_gemm_forward", [_P] * 5 + [_I] * 5 + [_P])
# int8_conv3x3_forward(x, s_x, w_q, s_w, out, n, h, w, c, o, s, pt, pl, ho,
# wo, in_code, out_code, stream)
CONV3X3_KERNEL = CudaKernel("int8_conv3x3", "int8_conv3x3_forward", [_P] * 5 + [_I] * 12 + [_P])
# csrc/int8_gemm.cu keeps the weights in shared memory for the block's life
# where their 64-K chunks of C_out rows (rounded up to its N sub-tile) take
# at most this many bytes; larger weights ride its TMA ring, which needs C a
# multiple of 16.
GEMM_RESIDENT_BYTES = 96 * 1024
# The filter of csrc/int8_hopper.cuh: RN(v · RN(1 / s_x)) more than δ = 2^-15
# from every half-integer rounds as RN(v / s_x) does.
FILTER_LIMIT = 0.5 - 2.0**-15
_FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)
_IN_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}


def out_size(size: int, kernel: int, stride: int, before: int, after: int) -> int:
    return (size + before + after - kernel) // stride + 1


def _check(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
           stride: int, pads: tuple[int, int, int, int],
           out_dtype: torch.dtype) -> tuple[int, int]:
    """Validate the op's arguments; return the output's (H, W)."""
    if x.dim() != 4 or x.dtype not in _IN_CODE:
        raise ValueError(f"int8_conv2d expects a float32, bfloat16 or float16 (N, H, W, C) x, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if s_x.dtype != torch.float32 or s_x.dim() != 0:
        raise ValueError(f"int8_conv2d expects a float32 0-dim s_x, got {s_x.dtype} "
                         f"{tuple(s_x.shape)}")
    o, kh, kw, c = w_q.shape if w_q.dim() == 4 else (0, 0, 0, 0)
    if w_q.dtype != torch.int8 or kh != kw or kh < 1 or c != x.shape[-1]:
        raise ValueError(f"int8_conv2d expects int8 (O, k, k, {x.shape[-1]}) weights, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if s_w.dtype != torch.float32 or tuple(s_w.shape) != (o,):
        raise ValueError(f"int8_conv2d expects a float32 ({o},) s_w, got {s_w.dtype} "
                         f"{tuple(s_w.shape)}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"int8_conv2d writes {sorted(map(str, _OUT_CODE))}, not {out_dtype}")
    if stride < 1 or min(pads) < 0:
        raise ValueError(f"int8_conv2d needs stride ≥ 1 and pads ≥ 0, got {stride} {pads}")
    pt, pb, pl, pr = pads
    ho = out_size(x.shape[1], kh, stride, pt, pb)
    wo = out_size(x.shape[2], kh, stride, pl, pr)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv2d: no output for input {tuple(x.shape)}, kernel {kh}, "
                         f"stride {stride}, pads {pads}")
    return ho, wo


def quantize(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clip(round(float32(x) / s_x), ±127)`` as int8, in x's layout."""
    xf = x.to(torch.float32, copy=True)
    return xf.div_(s_x).round_().clamp_(-127, 127).to(torch.int8)


def quantize_filtered(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``quantize`` by the GEMM and 3 × 3 kernels' rule
    (``csrc/int8_hopper.cuh``'s note), in float32 PyTorch, operation for operation: ``t =
    clamp(float32(x) · RN(1 / s_x), ±127)``; where ``|t − rint(t)| <
    FILTER_LIMIT``, ``rint(t)``, else ``quantize``'s IEEE division; all by
    division where ``RN(1 / s_x)`` is not a finite normal number. Equal to
    ``quantize`` bit for bit (``tests/test_torch_int8_filter.py``)."""
    r = torch.ones_like(s_x) / s_x
    exact = quantize(x, s_x)
    if not (torch.isfinite(r).item() and r.abs().item() >= _FLOAT32_TINY):
        return exact
    t = (x.to(torch.float32) * r).clamp_(-127, 127)
    n = t.round()
    safe = (t - n).abs_() < FILTER_LIMIT
    return torch.where(safe, n.to(torch.int8), exact)


def dequantize(sums: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """int32 sums (…, O) → ``float32(sums) · scale`` rounded into
    ``out_dtype``; the sums themselves for ``torch.int32``."""
    if out_dtype == torch.int32:
        return sums
    return (sums.to(torch.float32) * scale).to(out_dtype)


def int8_conv2d_sums_reference(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                               pads: tuple[int, int, int, int]) -> torch.Tensor:
    """Plain version of the s8 product: (N, H_out, W_out, O) int32 sums of
    the zero-padded conv of int8 x_q (N, H, W, C), exact (float64 over the
    int8 values; on a CUDA tensor with cuDNN off, so that the sum is the
    native im2col product's, never an FFT or Winograd transform)."""
    pt, pb, pl, pr = pads
    x = F.pad(x_q.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    w = w_q.permute(0, 3, 1, 2).to(torch.float64)
    off = torch.backends.cudnn.flags(enabled=False) if x.is_cuda else contextlib.nullcontext()
    with off:
        y = F.conv2d(x, w, stride=stride)
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv2d_reference(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor,
                          s_w: torch.Tensor, stride: int, pad_top: int, pad_bottom: int,
                          pad_left: int, pad_right: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``int8_conv2d``: ``quantize``, the exact sums, then
    ``dequantize`` by ``s_x · s_w``."""
    pads = (pad_top, pad_bottom, pad_left, pad_right)
    _check(x, s_x, w_q, s_w, stride, pads, out_dtype)
    sums = int8_conv2d_sums_reference(quantize(x, s_x), w_q, stride, pads)
    return dequantize(sums, s_x * s_w, out_dtype)


def gemm_weights_resident(c: int, o: int) -> bool:
    """Whether the GEMM kernel keeps C × O int8 weights in shared memory
    (``GEMM_RESIDENT_BYTES``) rather than in its TMA ring: its N sub-tile
    is 32, 64 or 128 channels by O."""
    width = 32 if o <= 32 else 64 if o <= 64 else 128
    return -(-c // 64) * 64 * (-(-o // width) * width) <= GEMM_RESIDENT_BYTES


def gemm_takes(x: torch.Tensor, w_q: torch.Tensor, stride: int, pads) -> bool:
    """Whether a conv goes to ``GEMM_KERNEL``: 1 × 1 at stride 1 without
    padding, more than 16 pixels and an even O, with x's memory as TMA
    reads it (16-byte aligned, rows of C a multiple of 16 bytes) and the
    weights either resident or as TMA reads them (C a multiple of 16,
    16-byte aligned); every other shape goes to ``conv3x3_takes``' test."""
    o, k = w_q.shape[:2]
    c = x.shape[-1]
    m = x.shape[0] * x.shape[1] * x.shape[2]
    if not (k == 1 and stride == 1 and not any(pads) and m > 16 and o % 2 == 0):
        return False
    rows = x.data_ptr() % 16 == 0 and (c * x.element_size()) % 16 == 0
    weights = gemm_weights_resident(c, o) or (c % 16 == 0 and w_q.data_ptr() % 16 == 0)
    return rows and weights


# csrc/int8_conv3x3.cu's plan: an instance by C_out (its N: C_out rounded up
# to 16, 64, 128 or 192) has tiles of 16 output columns by 4·kMB rows (kMB
# m64 blocks), 3 consumer warpgroups where N is 16 (kMB 4) or 128 (kMB 1)
# and two ring stages each fit, else 2 (kMB 2 where N ≤ 64, else 1),
# shared memory of 227 KB in 1024-byte aligned parts, three staging buffers
# a consumer warp (16 pixels of N 4-byte channels, at most 128 bytes a
# pixel) and up to 8 ring stages a consumer.
CONV3X3_SMEM = 227 * 1024
CONV3X3_MAX_STAGES = 8


def _conv3x3_stages(cs: int, n: int, stride: int, esize: int, consumers: int, blocks: int) -> int:
    """The kernel's ``plan``, the same sum: the resident weights, each
    consumer's int8 tile and staging buffers, the scale table and the
    mbarriers, then the ring stages that fit, each an input box of rows
    (4·kMB − 1)·s + 3 by columns 15·s + 3 by 16·cs channels."""
    r1k = lambda v: -(-v // 1024) * 1024  # noqa: E731
    positions = ((4 * blocks - 1) * stride + 3) * (15 * stride + 3)
    stage = r1k(positions * 16 * cs * esize)
    steps = (9 * cs + 1) // 2
    fixed = (1024 + (steps + 1) // 2 * n * 64
             + consumers * (r1k(positions * (cs | 1) * 16) + 4 * 3 * 16 * min(4 * n, 128))
             + r1k(n * 4) + 1024)
    return min(CONV3X3_MAX_STAGES, (CONV3X3_SMEM - fixed) // (consumers * stage))


def conv3x3_plan(c: int, o: int, stride: int, esize: int) -> tuple[int, int, int]:
    """(consumer warpgroups, m64 blocks a tile, ring stages a consumer) of
    the instance ``csrc/int8_conv3x3.cu`` launches for a 3 × 3 conv of C
    ``c`` (``esize``-byte elements) to O ``o`` at ``stride``; below 2
    stages the kernel refuses the shape."""
    cs = -(-c // 16)
    n = 16 if o <= 16 else 64 if o <= 64 else 128 if o <= 128 else 192
    if n in (16, 128):
        blocks = 4 if n == 16 else 1
        stages = _conv3x3_stages(cs, n, stride, esize, 3, blocks)
        if stages >= 2:
            return 3, blocks, stages
    blocks = 2 if n <= 64 else 1
    return 2, blocks, _conv3x3_stages(cs, n, stride, esize, 2, blocks)


def conv3x3_takes(x: torch.Tensor, w_q: torch.Tensor, stride: int) -> bool:
    """Whether a conv goes to ``CONV3X3_KERNEL``: 3 × 3 at stride 1 or 2,
    C at most 48, O a multiple of 8 up to 192, x's memory as TMA reads it
    (16-byte aligned, rows of C a multiple of 16 bytes), and at least two
    ring stages (``conv3x3_plan``). Any padding: TMA's zero fill is it."""
    o, k = w_q.shape[:2]
    c = x.shape[-1]
    if not (k == 3 and stride in (1, 2) and c <= 48 and o % 8 == 0 and o <= 192):
        return False
    if x.data_ptr() % 16 != 0 or (c * x.element_size()) % 16 != 0:
        return False
    return conv3x3_plan(c, o, stride, x.element_size())[2] >= 2


def _cuda_operands(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor):
    """The kernels' operands on x's device: x as its NHWC memory (a
    channels-last NCHW tensor permuted to NHWC is read in place; other
    layouts are copied), the rest contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernels need a CUDA tensor, got {x.device}")
    if any(t.device != x.device for t in (s_x, w_q, s_w)):
        raise ValueError("the int8 conv kernels need s_x, w_q and s_w on x's device")
    return x.contiguous(), s_x, w_q.contiguous(), s_w.contiguous()


def int8_conv_cuda(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                   stride: int, pads: tuple[int, int, int, int],
                   out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``int8_conv_forward`` (``KERNEL``)."""
    ho, wo = _check(x, s_x, w_q, s_w, stride, pads, out_dtype)
    x, s_x, w_q, s_w = _cuda_operands(x, s_x, w_q, s_w)
    n, h, w, c = x.shape
    o, k = w_q.shape[:2]
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
                      out.data_ptr(), n, h, w, c, o, k, stride, pads[0], pads[2], ho, wo,
                      _IN_CODE[x.dtype], _OUT_CODE[out_dtype], stream_handle(x))
    return out


def int8_conv3x3_cuda(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor,
                      s_w: torch.Tensor, stride: int, pads: tuple[int, int, int, int],
                      out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``int8_conv3x3_forward`` (``CONV3X3_KERNEL``)."""
    ho, wo = _check(x, s_x, w_q, s_w, stride, pads, out_dtype)
    x, s_x, w_q, s_w = _cuda_operands(x, s_x, w_q, s_w)
    n, h, w, c = x.shape
    o = w_q.shape[0]
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        CONV3X3_KERNEL.launch(x.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
                              out.data_ptr(), n, h, w, c, o, stride, pads[0], pads[2], ho, wo,
                              _IN_CODE[x.dtype], _OUT_CODE[out_dtype], stream_handle(x))
    return out


def int8_gemm_cuda(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``int8_gemm_forward`` (``GEMM_KERNEL``): the 1 × 1 conv
    at stride 1 without padding as the product of the N·H·W pixels' rows of
    x with w_q (O, C)."""
    _check(x, s_x, w_q, s_w, 1, (0, 0, 0, 0), out_dtype)
    if w_q.shape[1] != 1:
        raise ValueError(f"int8_gemm_cuda takes 1 × 1 weights, got {tuple(w_q.shape)}")
    x, s_x, w_q, s_w = _cuda_operands(x, s_x, w_q, s_w)
    n, h, w, c = x.shape
    o = w_q.shape[0]
    out = torch.empty((n, h, w, o), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        GEMM_KERNEL.launch(x.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
                           out.data_ptr(), n * h * w, c, o, _IN_CODE[x.dtype],
                           _OUT_CODE[out_dtype], stream_handle(x))
    return out


@torch.library.custom_op("bas_torch::int8_conv2d", mutates_args=(), device_types="cpu")
def int8_conv2d_op(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                   stride: int, pad_top: int, pad_bottom: int, pad_left: int, pad_right: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """``bas_torch::int8_conv2d``, the registered op: the plain version on
    a CPU tensor; on a CUDA tensor one kernel launch, through
    ``_int8_conv2d_cuda_route``."""
    return int8_conv2d_reference(x, s_x, w_q, s_w, stride, pad_top, pad_bottom, pad_left,
                                 pad_right, out_dtype)


@int8_conv2d_op.register_kernel("cuda")
def _int8_conv2d_cuda_route(x, s_x, w_q, s_w, stride, pad_top, pad_bottom, pad_left,
                            pad_right, out_dtype):
    """A CUDA tensor's route: ``GEMM_KERNEL`` where ``gemm_takes`` the
    shape, else ``CONV3X3_KERNEL`` where ``conv3x3_takes`` it, else
    ``KERNEL``."""
    pads = (pad_top, pad_bottom, pad_left, pad_right)
    if gemm_takes(x, w_q, stride, pads):
        return int8_gemm_cuda(x, s_x, w_q, s_w, out_dtype)
    if conv3x3_takes(x, w_q, stride):
        return int8_conv3x3_cuda(x, s_x, w_q, s_w, stride, pads, out_dtype)
    return int8_conv_cuda(x, s_x, w_q, s_w, stride, pads, out_dtype)


def _setup_backward(ctx, inputs, output):
    x, s_x, w_q, s_w, stride, pad_top, pad_bottom, pad_left, pad_right, _ = inputs
    ctx.save_for_backward(x, s_x, w_q, s_w)
    ctx.conv = (stride, (pad_top, pad_bottom, pad_left, pad_right))


def _backward(ctx, grad):
    """JAX's gradient (module docstring): zero for x, none for the int8
    w_q, and the dequantizing product's for ``s_x`` and ``s_w``."""
    x, s_x, w_q, s_w = ctx.saved_tensors
    stride, pads = ctx.conv
    sums = int8_conv2d(x.detach(), s_x.detach(), w_q, s_w.detach(), stride, pads, torch.int32)
    per_channel = (grad.to(torch.float32) * sums.to(torch.float32)).sum(dim=(0, 1, 2))
    return (torch.zeros_like(x), (per_channel * s_w).sum(), None, per_channel * s_x,
            None, None, None, None, None, None)


int8_conv2d_op.register_autograd(_backward, setup_context=_setup_backward)


@int8_conv2d_op.register_fake
def _int8_conv2d_fake(x, s_x, w_q, s_w, stride, pad_top, pad_bottom, pad_left, pad_right,
                      out_dtype):
    ho, wo = _check(x, s_x, w_q, s_w, stride, (pad_top, pad_bottom, pad_left, pad_right),
                    out_dtype)
    return x.new_empty((x.shape[0], ho, wo, w_q.shape[0]), dtype=out_dtype)


def int8_conv2d(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                stride: int, pads: tuple[int, int, int, int],
                out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv of x (N, H, W, C) in the compute dtype, quantized by
    ``s_x``, with w_q (O, k, k, C) and ``pads`` (top, bottom, left, right),
    dequantized by ``s_x · s_w`` into ``out_dtype`` (module docstring):
    ``bas_torch::int8_conv2d``."""
    return int8_conv2d_op(x, s_x, w_q, s_w, stride, *pads, out_dtype)
