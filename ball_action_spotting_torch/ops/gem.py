"""GeM pooling: ``mean(max(x, eps)^p)^(1/p)`` over (H, W), with a learnable
scalar ``p``.

Port of the JAX package's ``ops/pallas_gem.py``. ``gem_pool`` takes
(B, H, W, C) channels-last input and a (1,) float32 ``p`` and returns (B, C)
float32. It is the ``torch.library`` custom op ``bas_torch::gem_pool``, so
that ``torch.export`` keeps it as one node of a sealed program. On a CUDA
tensor the op's forward is the hand-written kernel ``csrc/gem.cu`` (16-byte
loads where ``wide_path`` allows them, H·W split over ``gem_splits`` blocks
where the batch fills too few); on a CPU tensor it is the plain version
``gem_pool_reference``. The backward, registered with the op, is the plain
PyTorch formula of the JAX custom VJP (``_gem_bwd``) on both, since the JAX
package has no backward kernel.

Spatial partitioning (``parallel/spatial.py``) pools a height-banded map:
``gem_pool_partial`` (``bas_torch::gem_pool_partial``) is the band-partial
launch of the same kernel, (B, H_band, W, C) → (B, C) float32 sums of
``max(x, eps)^p`` with no mean and no root (``gem_pool_partial_reference``
on a CPU tensor; its backward plain PyTorch), counted under the kernel's
``launches_by["partial"]``; ``gem_pool_bands`` adds the bands' sums in band
order and takes ``(sum / (H·W))^(1/p)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle
from ball_action_spotting_torch.parallel.spatial import Bands, add_in_order

KERNEL = CudaKernel(
    "gem", "gem_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
)
PARTIAL = "partial"  # the band-partial launch's tag in KERNEL.launches_by
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WARPS = 4  # csrc/gem.cu's warps per block, each over its own positions


def wide_path(x: torch.Tensor) -> bool:
    """Whether ``csrc/gem.cu`` loads 16 bytes of channels per lane for a
    contiguous (B, H, W, C) ``x``: C·itemsize a multiple of 16 and x
    16-byte aligned; else one channel per lane."""
    return (x.shape[-1] * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gem_splits(b: int, hw: int, c: int, vec: int, sms: int) -> int:
    """Blocks over the H·W positions of one (batch row, channel tile): 1
    where the B × ceil(C / (32·vec)) tiles give at least two blocks per SM,
    else enough splits for that, each with at least four positions per
    warp."""
    tiles = b * -(-c // (32 * vec))
    if tiles >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), hw // (4 * _WARPS)))


def gem_pool_reference(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: (B, H, W, C), p (1,) → (B, C) float32."""
    x = x.float().clamp_min(eps)
    pooled = torch.exp(p * torch.log(x)).mean(dim=(1, 2))
    return torch.exp(torch.log(pooled) / p)


def _check_shapes(x: torch.Tensor, p: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"gem_pool expects (B, H, W, C), got shape {tuple(x.shape)}")
    if tuple(p.shape) != (1,):
        raise ValueError(f"gem_pool expects p of shape (1,), got {tuple(p.shape)}")


def gem_pool_cuda(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/gem.cu`` on a CUDA (B, H, W, C) tensor."""
    return _launch(x, p, eps, root=True)


def gem_pool_partial_cuda(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/gem.cu``'s band-partial sums on a CUDA (B, H, W, C)
    tensor: (B, C) float32 sums of ``max(x, eps)^p``."""
    return _launch(x, p, eps, root=False)


def _launch(x: torch.Tensor, p: torch.Tensor, eps: float, root: bool) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"gem_pool_cuda needs a CUDA tensor, got {x.device}")
    _check_shapes(x, p)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"gem_pool kernel takes float32/bfloat16/float16, got {x.dtype}")
    if p.dtype != torch.float32 or p.device != x.device:
        raise ValueError("gem_pool kernel needs p in float32 on x's device")
    b, h, w, c = x.shape
    if min(b, h, w, c) == 0:
        raise ValueError(f"gem_pool kernel got an empty tensor {tuple(x.shape)}")
    x = x.contiguous()
    p = p.contiguous()
    wide = wide_path(x)
    vec = 16 // x.element_size() if wide else 1
    splits = gem_splits(b, h * w, c, vec, _sm_count(x.device.index))
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, b, c), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), p.data_ptr(), out.data_ptr(),
                      None if partial is None else partial.data_ptr(), b, h * w, c,
                      float(eps), _DTYPE_CODE[x.dtype], int(wide), splits, int(root),
                      stream_handle(x), tag=None if root else PARTIAL)
    return out


def gem_pool_backward_reference(x, p, y, grad, eps: float = 1e-6):
    """The JAX custom VJP's backward: (dx, dp) for y = gem_pool(x, p)."""
    n = x.shape[1] * x.shape[2]
    pf = p.reshape(()).float()
    xc = x.float().clamp_min(eps)
    logx = torch.log(xc)
    powed = torch.exp(pf * logx)  # xc^p
    m = powed.mean(dim=(1, 2))  # (B, C)
    safe_m = m.clamp_min(1e-30)

    # dy/dx = y^(1-p) · xc^(p-1) / N on the unclamped region
    coeff = (y ** (1.0 - pf))[:, None, None, :] / n
    dx = coeff * torch.exp((pf - 1.0) * logx)
    dx = torch.where(x > eps, dx, torch.zeros_like(dx))
    dx = (dx * grad[:, None, None, :]).to(x.dtype)

    # dy/dp: y = exp(log m / p) ⇒ dy/dp = y·(dm/dp / (p·m) − log m / p²)
    dm_dp = (powed * logx).mean(dim=(1, 2))
    dy_dp = y * (dm_dp / (pf * safe_m) - torch.log(safe_m) / (pf * pf))
    dp = (dy_dp * grad).sum().reshape(p.shape).to(p.dtype)
    return dx, dp


@torch.library.custom_op("bas_torch::gem_pool", mutates_args=(), device_types="cpu")
def gem_pool_op(x: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    """``bas_torch::gem_pool``, the registered op: the plain version on a
    CPU tensor, the kernel on a CUDA tensor (``gem_pool_cuda``)."""
    _check_shapes(x, p)
    return gem_pool_reference(x, p, eps)


gem_pool_op.register_kernel("cuda", gem_pool_cuda)


@gem_pool_op.register_fake
def _gem_pool_fake(x: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    _check_shapes(x, p)
    return x.new_empty((x.shape[0], x.shape[3]), dtype=torch.float32)


def _gem_setup_context(ctx, inputs, output) -> None:
    x, p, eps = inputs
    ctx.save_for_backward(x, p, output)
    ctx.eps = eps


def _gem_backward(ctx, grad):
    x, p, y = ctx.saved_tensors
    dx, dp = gem_pool_backward_reference(x, p, y, grad, ctx.eps)
    return dx, dp, None


gem_pool_op.register_autograd(_gem_backward, setup_context=_gem_setup_context)


def gem_pool(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GeM pooling: (B, H, W, C) → (B, C) float32; ``p`` shape (1,).

    Calls ``bas_torch::gem_pool``: a CUDA tensor goes through the kernel (or
    raises), a CPU tensor through the plain version."""
    _check_shapes(x, p)
    return gem_pool_op(x, p, eps)


def gem_pool_partial_reference(x: torch.Tensor, p: torch.Tensor,
                               eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the band-partial sums: (B, H, W, C), p (1,) →
    (B, C) float32 ``Σ_hw max(x, eps)^p``."""
    x = x.float().clamp_min(eps)
    return torch.exp(p * torch.log(x)).sum(dim=(1, 2))


def gem_pool_partial_backward_reference(x, p, grad, eps: float = 1e-6):
    """(dx, dp) of the band-partial sums: ``p·max(x, eps)^(p−1)·[x > eps]``
    for x and ``Σ max(x, eps)^p·ln max(x, eps)`` for p, each times ``grad``."""
    pf = p.reshape(()).float()
    xc = x.float().clamp_min(eps)
    logx = torch.log(xc)
    dx = pf * torch.exp((pf - 1.0) * logx)
    dx = torch.where(x > eps, dx, torch.zeros_like(dx))
    dx = (dx * grad[:, None, None, :]).to(x.dtype)
    dp = ((torch.exp(pf * logx) * logx).sum(dim=(1, 2)) * grad).sum()
    return dx, dp.reshape(p.shape).to(p.dtype)


@torch.library.custom_op("bas_torch::gem_pool_partial", mutates_args=(), device_types="cpu")
def gem_pool_partial_op(x: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    """``bas_torch::gem_pool_partial``: the plain version on a CPU tensor,
    the kernel's band-partial launch on a CUDA tensor."""
    _check_shapes(x, p)
    return gem_pool_partial_reference(x, p, eps)


gem_pool_partial_op.register_kernel("cuda", gem_pool_partial_cuda)


@gem_pool_partial_op.register_fake
def _gem_pool_partial_fake(x: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    _check_shapes(x, p)
    return x.new_empty((x.shape[0], x.shape[3]), dtype=torch.float32)


def _gem_partial_setup_context(ctx, inputs, output) -> None:
    x, p, eps = inputs
    ctx.save_for_backward(x, p)
    ctx.eps = eps


def _gem_partial_backward(ctx, grad):
    x, p = ctx.saved_tensors
    dx, dp = gem_pool_partial_backward_reference(x, p, grad, ctx.eps)
    return dx, dp, None


gem_pool_partial_op.register_autograd(_gem_partial_backward,
                                      setup_context=_gem_partial_setup_context)


def gem_pool_partial(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Band-partial GeM sums: (B, H_band, W, C) → (B, C) float32
    ``Σ max(x, eps)^p``; ``p`` shape (1,). Calls
    ``bas_torch::gem_pool_partial``: the kernel on a CUDA tensor (or
    raises), the plain version on a CPU tensor."""
    _check_shapes(x, p)
    return gem_pool_partial_op(x, p, eps)


def gem_pool_bands(x: Bands, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GeM over a (B, H, W, C) map cut into height bands (axis 1): each
    band's partial sums (an empty band adds zeros and launches nothing),
    added in band order on the first band's device, then
    ``(sum / (H·W))^(1/p)`` there: (B, C) float32 on the first band's
    device. ``p`` may lie on another device; it is copied to each band's."""
    if x.axis != 1 or len(x.shape) != 4:
        raise ValueError(f"gem_pool_bands expects (B, H, W, C) bands cut on axis 1, got "
                         f"shape {x.shape} cut on axis {x.axis}")
    b, h, w, c = x.shape
    partials = [gem_pool_partial(part, p.to(dev), eps) if part.shape[1] else
                torch.zeros((b, c), dtype=torch.float32, device=dev)
                for part, dev in zip(x.parts, x.devices)]
    pooled = add_in_order(partials, x.devices[0]) / (h * w)
    return torch.exp(torch.log(pooled) / p.to(x.devices[0]))
