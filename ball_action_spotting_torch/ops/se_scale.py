"""The squeeze-excite gate multiply: ``x * gate``, with one gate value per
image and channel.

``se_scale`` is what ``models/effnetv2.py::SqueezeExcite2d`` and
``models/blocks3d.py::SqueezeExcite3d`` run once their gate (the sigmoid of
the excite convs over the image's mean) is known. It calls the
``torch.library`` custom op ``bas_torch::se_scale`` on the tensor seen with
its channels last and the gate as (N, C). On a CUDA tensor the op launches
the hand-written kernel ``csrc/se_scale.cu``: one read of the map and one
write, in the input's layout: channels innermost (channels-last NCHW, the
3D head's (N, ..., C)) or a plane per channel (contiguous NCHW, as the
space-to-depth stem's encoder runs); any other view is made dense with the
channels innermost first, and the kernel reads one element a thread where
C (or the plane) or a pointer does not fit its 16-byte vectors. On a CPU
tensor the op runs the plain ``x * gate`` (``se_scale_reference``). The
kernel widens to float32, multiplies and rounds once, as ATen's ``mul``
does, so both give the same bits. A gate of another shape or dtype than
x's raises. The gradient is the plain multiply's. Each call counts its
route under the tracer's counters ``se_scale.kernel`` and
``se_scale.plain`` (``utils/profiling.py``); a launch on planes counts
under ``KERNEL.launches_by["planes"]`` too.
"""

from __future__ import annotations

import ctypes

import torch

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle
from ball_action_spotting_torch.ops.bias_act import channel_planes
from ball_action_spotting_torch.utils.profiling import count

KERNEL = CudaKernel(
    "se_scale", "se_scale_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
PLANES = "planes"  # the launches on a plane per channel, in KERNEL.launches_by
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def se_scale_reference(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain version, channels on the last axis: ``x * gate`` with the
    (N, C) gate broadcast over every axis between."""
    return x * gate.view(gate.shape[0], *(1,) * (x.dim() - 2), gate.shape[1])


def _check(x: torch.Tensor, gate: torch.Tensor) -> None:
    want = (x.shape[0], x.shape[-1]) if x.dim() >= 2 else None
    if want is None or tuple(gate.shape) != want or gate.dtype != x.dtype:
        raise ValueError(f"se_scale expects a gate of {want} in {x.dtype}, got "
                         f"{tuple(gate.shape)} in {gate.dtype}")


def kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` (channels on its last axis) as the kernel reads it: ``x``
    itself where its channels are innermost and dense or it holds a plane
    per channel (``channel_planes``), else a dense copy with the channels
    innermost."""
    return x if channel_planes(x) else x.contiguous()


def se_scale_cuda(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/se_scale.cu`` on a dense CUDA tensor with channels on
    its last axis: channels innermost (``x.is_contiguous()``) or a plane per
    channel (``channel_planes``), and a contiguous gate; the output keeps
    x's layout. Its C entry point takes 16-byte vectors where C (or the
    plane) and the pointers allow, else one element a thread."""
    _check(x, gate)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"se_scale kernel takes float32/bfloat16/float16, got {x.dtype}")
    planes = channel_planes(x)
    if not (planes or x.is_contiguous()) or not gate.is_contiguous():
        raise ValueError("se_scale kernel needs x dense, channels innermost or a plane per "
                         "channel, and a contiguous gate")
    if x.device.type != "cuda" or gate.device != x.device:
        raise ValueError("se_scale kernel needs x and gate on one CUDA device")
    out = torch.empty_like(x)  # x's strides: the same layout
    if x.numel() == 0:
        return out
    n, c = gate.shape
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), gate.data_ptr(), out.data_ptr(), n, x.numel() // (n * c), c,
                      int(planes), _DTYPE_CODE[x.dtype], stream_handle(x),
                      tag=PLANES if planes else None)
    return out


@torch.library.custom_op("bas_torch::se_scale", mutates_args=(), device_types="cpu")
def se_scale_op(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``bas_torch::se_scale``, the registered op (channels on the last
    axis, gate (N, C)): the plain version on a CPU tensor, the kernel on a
    CUDA tensor (``se_scale_cuda``)."""
    _check(x, gate)
    return se_scale_reference(x, gate)


se_scale_op.register_kernel("cuda", se_scale_cuda)


@se_scale_op.register_fake
def _se_scale_fake(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    _check(x, gate)
    return torch.empty_like(x)


def _se_scale_setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _se_scale_backward(ctx, grad):
    """The plain multiply's gradient: ``grad * gate``, and ``grad * x``
    summed over every axis between the batch and the channels."""
    x, gate = ctx.saved_tensors
    dx = se_scale_reference(grad, gate) if ctx.needs_input_grad[0] else None
    dgate = (grad * x).sum(tuple(range(1, x.dim() - 1))) if ctx.needs_input_grad[1] else None
    return dx, dgate


se_scale_op.register_autograd(_se_scale_backward, setup_context=_se_scale_setup_context)


def se_scale(x: torch.Tensor, gate: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
    """``x * gate``, the SE scale of ``x``: ``gate`` has x's shape with 1 on
    every axis but the batch and the channel axis, which is x's last where
    ``channels_last``, else axis 1 (the op sees it moved last), and x's
    dtype; any other gate raises."""
    axis = x.dim() - 1 if channels_last else 1
    n, c = x.shape[0], x.shape[axis]
    want = tuple(n if d == 0 else c if d == axis else 1 for d in range(x.dim()))
    if tuple(gate.shape) != want or gate.dtype != x.dtype:
        raise ValueError(f"se_scale expects a gate of {want} in {x.dtype}, got "
                         f"{tuple(gate.shape)} in {gate.dtype}")
    xv = x if channels_last else x.movedim(1, -1)
    if x.is_cuda:  # the kernel reads a dense layout, channels innermost or in planes
        count("se_scale.kernel")
        xv = kernel_view(xv)
    else:
        count("se_scale.plain")
    out = se_scale_op(xv, gate.reshape(n, c).contiguous())
    return out if channels_last else out.movedim(-1, 1)
