"""3D temporal-fusion blocks and GeM pooling (port of the JAX package's
``models/blocks3d.py``). Layout is channels-last (N, T, H, W, C) as in JAX:
the pointwise convs are matmuls over the last axis, and the depthwise conv
and GeM take channels-last input, which is what their kernels read
contiguously. BN here uses torch defaults (eps 1e-5), unlike the encoder's
TF-ported 1e-3. Each module also takes its input cut into height bands
(``parallel/spatial.py``, axis 2 of (N, T, H, W, C), axis 1 of GeM's
(B, H, W, C)): the depthwise conv on halo windows, the SE mean and GeM as
sums over the bands."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ball_action_spotting_torch.models.effnetv2 import (
    BatchNormAct,
    DropPath,
    PointwiseConv,
    bn_skip,
)
from ball_action_spotting_torch.ops.dwconv3d import KERNEL as DW_KERNEL
from ball_action_spotting_torch.ops.dwconv3d import (
    dwconv3d,
    dwconv3d_bands,
    dwconv3d_grouped_conv,
)
from ball_action_spotting_torch.ops.gem import KERNEL as GEM_KERNEL
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_bands
from ball_action_spotting_torch.ops.se_scale import KERNEL as SE_SCALE_KERNEL
from ball_action_spotting_torch.ops.se_scale import se_scale
from ball_action_spotting_torch.parallel.spatial import Bands, band_sum


class DepthwiseConv3d(nn.Module):
    """3×3×3 depthwise SAME conv, weight (C, 1, 3, 3, 3). The default path
    is ``F.conv3d(groups=C)``, the counterpart of the JAX package's lax
    grouped conv; ``use_kernel=True`` routes inference through
    ``ops/dwconv3d.py`` (the hand-written kernel on a CUDA tensor)."""

    def __init__(self, features: int, use_kernel: bool = False):
        super().__init__()
        self.use_kernel = use_kernel
        self.weight = nn.Parameter(torch.empty(features, 1, 3, 3, 3))

    @property
    def cuda_kernels(self) -> tuple:
        """The hand-written kernels this module launches on a CUDA tensor."""
        return (DW_KERNEL,) if self.use_kernel else ()

    def forward(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        kernel = self.weight.to(x.dtype).permute(2, 3, 4, 1, 0)  # (3, 3, 3, 1, C)
        if isinstance(x, Bands):
            return dwconv3d_bands(x, kernel, self.use_kernel and not self.training)
        if self.use_kernel and not self.training:
            return dwconv3d(x, kernel)
        return dwconv3d_grouped_conv(x, kernel)


class SqueezeExcite3d(nn.Module):
    """SE over (T, H, W); reduction = channels // reduce_ratio of the
    expanded width it is given."""

    def __init__(self, channels: int, reduce_ratio: int = 8, act: Callable = F.silu):
        super().__init__()
        self.act = act
        rd = channels // reduce_ratio
        self.conv_reduce = PointwiseConv(channels, rd, ndim=3, bias=True)
        self.conv_expand = PointwiseConv(rd, channels, ndim=3, bias=True)

    cuda_kernels = (SE_SCALE_KERNEL,)  # the hand-written kernels this module launches

    def forward(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        """``x`` times the gate, the sigmoid of the excite convs over its
        mean, in one pass (``ops/se_scale.py``)."""
        if isinstance(x, Bands):  # the mean over every band's rows
            _, t, h, w, _ = x.shape
            return x.map_with(band_sum(x, (1, 2, 3)), lambda part, total: se_scale(
                part, torch.sigmoid(self._excite(
                    (total / (t * h * w)).to(part.dtype)[:, None, None, None])),
                channels_last=True))
        se = x.mean(dim=(1, 2, 3), keepdim=True)
        return se_scale(x, torch.sigmoid(self._excite(se)), channels_last=True)

    def _excite(self, se: torch.Tensor) -> torch.Tensor:
        return self.conv_expand(self.act(self.conv_reduce(se)))


class InvertedResidual3d(nn.Module):
    """MBConv-style 3D block: 1×1×1 expand → 3×3×3 depthwise → SE →
    1×1×1 project, residual (its branch dropped at ``drop_path_rate`` in
    training). Input/output: (B, T, H, W, C)."""

    bn_eps = 1e-5  # torch BatchNorm3d default; read by models/fold_bn.py

    def __init__(self, features: int, expansion_ratio: int = 6,
                 se_reduce_ratio: int = 24, act: Callable = F.silu,
                 bn_folded: bool = False, dw_use_kernel: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        mid = features * expansion_ratio
        eps = self.bn_eps
        self.conv_pw = PointwiseConv(features, mid, ndim=3)
        self.bn1 = BatchNormAct(mid, act, eps, bn_folded, channels_last=True)
        self.conv_dw = DepthwiseConv3d(mid, use_kernel=dw_use_kernel)
        self.bn2 = BatchNormAct(mid, act, eps, bn_folded, channels_last=True)
        self.se = SqueezeExcite3d(mid, se_reduce_ratio, act)
        self.conv_pwl = PointwiseConv(mid, features, ndim=3)
        self.bn3 = BatchNormAct(features, None, eps, bn_folded, channels_last=True)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv_dw(self.bn1(self.conv_pw(x))))
        return bn_skip(self.bn3, self.drop_path, self.conv_pwl(self.se(out)), x)


class GeneralizedMeanPooling(nn.Module):
    """GeM pooling ``mean(clamp(x, eps)^p)^(1/p)`` over (H, W) with a
    learnable scalar ``p``: (B, H, W, C) → (B, C) float32. Always through
    ``ops/gem.py`` (the kernel on a CUDA tensor); bands through
    ``gem_pool_bands``, the pooled (B, C) on the first band's device."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.full((1,), p_init))

    cuda_kernels = (GEM_KERNEL,)  # the hand-written kernels this module launches

    def forward(self, x: torch.Tensor | Bands) -> torch.Tensor:
        if isinstance(x, Bands):
            return gem_pool_bands(x, self.p, self.eps)
        return gem_pool(x, self.p, self.eps)
