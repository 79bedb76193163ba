"""GeM pooling: ``mean(max(x, eps)^p)^(1/p)`` over (H, W), with a learnable
scalar ``p``.

Port of the JAX package's ``ops/pallas_gem.py``. ``gem_pool`` takes
(B, H, W, C) channels-last input and a (1,) float32 ``p`` and returns (B, C)
float32. On a CUDA tensor the forward is the hand-written kernel
``csrc/gem.cu``; on a CPU tensor it is the plain version
``gem_pool_reference``. The backward is the plain PyTorch formula of the JAX
custom VJP (``_gem_bwd``) on both, since the JAX package has no backward
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ball_action_spotting_torch.ops._cuda import CudaKernel, stream_handle

KERNEL = CudaKernel(
    "gem", "gem_forward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
    if x.device.type != "cuda":
        raise ValueError(f"gem_pool_cuda needs a CUDA tensor, got {x.device}")
    _check_shapes(x, p)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"gem_pool kernel takes float32/bfloat16/float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gem_pool kernel needs a contiguous channels-last tensor")
    if p.dtype != torch.float32 or p.device != x.device:
        raise ValueError("gem_pool kernel needs p in float32 on x's device")
    b, h, w, c = x.shape
    if min(b, h, w, c) == 0:
        raise ValueError(f"gem_pool kernel got an empty tensor {tuple(x.shape)}")
    p = p.contiguous()
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), p.data_ptr(), out.data_ptr(), b, h * w, c,
                      float(eps), _DTYPE_CODE[x.dtype], stream_handle(x))
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


class _GemPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, eps):
        if x.device.type == "cuda":
            y = gem_pool_cuda(x, p, eps)
        else:
            _check_shapes(x, p)
            y = gem_pool_reference(x, p, eps)
        ctx.save_for_backward(x, p, y)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, grad):
        x, p, y = ctx.saved_tensors
        dx, dp = gem_pool_backward_reference(x, p, y, grad, ctx.eps)
        return dx, dp, None


def gem_pool(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GeM pooling: (B, H, W, C) → (B, C) float32; ``p`` shape (1,).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the plain version."""
    return _GemPool.apply(x, p, eps)
