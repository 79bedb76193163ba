"""The folded BatchNorm's inference epilogue: the per-channel bias, SiLU (or
no activation) and the block's residual add, in one pass.

``bias_act`` is what ``models/effnetv2.py::BatchNormAct`` runs in its folded
form (the BN's scale folded into the preceding conv, ``models/fold_bn.py``).
It calls the ``torch.library`` custom op ``bas_torch::bias_act`` on the
tensor seen with its channels last. On a CUDA tensor the op launches the
hand-written kernel ``csrc/bias_act.cu``: one read of the conv output (and
of the residual) and one write, in the input's layout: channels innermost
(channels-last NCHW, the 3D head's (..., C)) or a plane per channel
(contiguous NCHW); any other view is made dense with the channels
innermost first, and the kernel reads one element a thread where C (or the
plane) or a pointer does not fit its 16-byte vectors. On a CPU tensor the op runs the plain sequence
``bias_act_reference``, which is what the folded BN ran before the kernel:
``x + bias``, then the activation, then ``+ residual``, each rounded to the
tensor's dtype. The kernel keeps those rounding points and ATen's SiLU
formula, so both give the same bits. An activation the kernel does not
compute raises (``BatchNormAct`` applies it apart). Each call counts its
route under the tracer's counters ``bias_act.kernel`` and ``bias_act.plain``
(``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle
from ball_action_spotting_torch.utils.profiling import count

KERNEL = CudaKernel(
    "bias_act", "bias_act_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODE = {"none": 0, "silu": 1}
ACTS = {None: "none", F.silu: "silu"}  # the activations the kernel computes


def bias_act_reference(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                       act: str) -> torch.Tensor:
    """Plain version, channels on the last axis: ``x + bias`` (``bias`` in
    x's dtype), SiLU where ``act`` is ``"silu"``, then ``+ residual``."""
    y = x + bias
    if act == "silu":
        y = F.silu(y)
    return y if residual is None else y + residual


def _check(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
           act: str) -> None:
    if act not in _ACT_CODE:
        raise ValueError(f"bias_act computes {sorted(_ACT_CODE)}, got act {act!r}")
    if x.dim() == 0 or tuple(bias.shape) != (x.shape[-1],) or bias.dtype != x.dtype:
        raise ValueError(f"bias_act expects a bias of ({x.shape[-1] if x.dim() else '?'},) in "
                         f"{x.dtype}, got {tuple(bias.shape)} in {bias.dtype}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"bias_act's residual {tuple(residual.shape)} {residual.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")


def channel_planes(x: torch.Tensor) -> bool:
    """Whether ``x`` (channels on its last axis) holds a plane per channel:
    the view of an NCHW tensor in contiguous memory. Not where its channels
    are also innermost and dense, which ``x.is_contiguous()`` says."""
    return x.dim() > 2 and not x.is_contiguous() and x.movedim(-1, 1).is_contiguous()


def bias_act_cuda(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                  act: str) -> torch.Tensor:
    """Launch ``csrc/bias_act.cu`` on a dense CUDA tensor with channels on
    its last axis: channels innermost (``x.is_contiguous()``) or a plane per
    channel (``channel_planes``), the residual in the same layout; the
    output keeps it. Its C entry point takes 16-byte vectors where C (or the
    plane) and the pointers allow, else one element a thread."""
    _check(x, bias, residual, act)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"bias_act kernel takes float32/bfloat16/float16, got {x.dtype}")
    tensors = (x, bias) if residual is None else (x, bias, residual)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("bias_act kernel needs x, bias and residual on one CUDA device")
    planes = channel_planes(x)
    if not (planes or x.is_contiguous()) or not bias.is_contiguous() or (
            residual is not None and not (channel_planes(residual) if planes
                                          else residual.is_contiguous())):
        raise ValueError("bias_act kernel needs x and residual dense, channels innermost or "
                         "a plane per channel, both alike, and a contiguous bias")
    out = torch.empty_like(x)  # x's strides: the same layout
    if x.numel() == 0:
        return out
    c = x.shape[-1]
    rows, inner = (x.shape[0], x.numel() // (x.shape[0] * c)) if planes else (x.numel() // c, 1)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), bias.data_ptr(),
                      None if residual is None else residual.data_ptr(), out.data_ptr(),
                      rows, c, inner, _DTYPE_CODE[x.dtype], _ACT_CODE[act], stream_handle(x))
    return out


@torch.library.custom_op("bas_torch::bias_act", mutates_args=(), device_types="cpu")
def bias_act_op(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                act: str) -> torch.Tensor:
    """``bas_torch::bias_act``, the registered op (channels on the last
    axis): the plain version on a CPU tensor, the kernel on a CUDA tensor
    (``bias_act_cuda``)."""
    _check(x, bias, residual, act)
    return bias_act_reference(x, bias, residual, act)


bias_act_op.register_kernel("cuda", bias_act_cuda)


@bias_act_op.register_fake
def _bias_act_fake(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                   act: str) -> torch.Tensor:
    _check(x, bias, residual, act)
    return torch.empty_like(x)


def _bias_act_setup_context(ctx, inputs, output) -> None:
    x, bias, residual, act = inputs
    ctx.save_for_backward(x, bias)
    ctx.act, ctx.has_residual = act, residual is not None


def _bias_act_backward(ctx, grad):
    """The plain version's gradient (the folded BN is inference-only; this
    keeps a differentiated eval pass working)."""
    x, bias = ctx.saved_tensors
    with torch.enable_grad():
        xg, bg = x.detach().requires_grad_(), bias.detach().requires_grad_()
        dx, db = torch.autograd.grad(bias_act_reference(xg, bg, None, ctx.act), (xg, bg), grad)
    return dx, db, grad if ctx.has_residual else None, None


bias_act_op.register_autograd(_bias_act_backward, setup_context=_bias_act_setup_context)


def bias_act(x: torch.Tensor, bias: torch.Tensor, act: Optional[Callable] = None,
             residual: Optional[torch.Tensor] = None,
             channels_last: bool = True) -> torch.Tensor:
    """The folded BN's epilogue of ``x``: ``act(x + bias)`` then ``+
    residual``, each step rounded to x's dtype; ``act`` is one of ``ACTS``.
    ``channels_last`` says whether channels are x's last axis; else axis 1
    (the op sees them moved last). ``residual`` has x's shape."""
    if act not in ACTS:
        raise ValueError(f"bias_act computes SiLU or no activation, got {act!r}")
    xv, rv = x, residual
    if not channels_last:
        xv = x.movedim(1, -1)
        rv = None if residual is None else residual.movedim(1, -1)
    if x.is_cuda:  # the kernel reads a dense layout, channels innermost or in planes
        count("bias_act.kernel")
        planes = channel_planes(xv)
        if not planes:
            xv = xv.contiguous()
        if rv is not None:
            rv = rv.movedim(-1, 1).contiguous().movedim(1, -1) if planes else rv.contiguous()
    else:
        count("bias_act.plain")
    out = bias_act_op(xv, bias.to(x.device, x.dtype), rv, ACTS[act])
    return out if channels_last else out.movedim(-1, 1)
