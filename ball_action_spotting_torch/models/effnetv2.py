"""EfficientNetV2 2D encoder family (port of the JAX package's
``models/effnetv2.py``).

The arch table, ``resolve_arch``, ``round_channels`` and the feature taps
are copies. Modules run NCHW internally, as PyTorch's convolutions prefer
(the callers hand them channels-last memory, which cuDNN keeps), and
reproduce the TF-ported weights' conventions: TF "SAME" padding, which puts
the extra pixel of a stride-2 conv at the bottom/right, and BatchNorm eps
1e-3. Module and parameter names follow the Flax modules (``conv_stem``,
``bn1``, ``blocks_{stage}_{rep}``, ``conv_pw``, ``se.conv_reduce`` ...), so
``convert.py`` maps one state onto the other. In training mode BN uses
batch statistics and the residual blocks drop paths. ``stem_space_to_depth``
is the JAX package's space-to-depth stem (``stem_kernel_to_s2d`` maps a
trained stem onto it); the int8 convs of the JAX package are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ball_action_spotting_torch.parallel.multihost import in_process_group


@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str  # "cn" conv | "er" edge/fused | "ir" inverted residual
    repeats: int
    kernel: int
    stride: int
    expand: int
    channels: int
    se_ratio: float = 0.0


_V2_BASE = (
    32,
    (
        BlockDef("cn", 1, 3, 1, 1, 16),
        BlockDef("er", 2, 3, 2, 4, 32),
        BlockDef("er", 2, 3, 2, 4, 48),
        BlockDef("ir", 3, 3, 2, 4, 96, 0.25),
        BlockDef("ir", 5, 3, 1, 6, 112, 0.25),
        BlockDef("ir", 8, 3, 2, 6, 192, 0.25),
    ),
)
_V2_S = (
    24,
    (
        BlockDef("cn", 2, 3, 1, 1, 24),
        BlockDef("er", 4, 3, 2, 4, 48),
        BlockDef("er", 4, 3, 2, 4, 64),
        BlockDef("ir", 6, 3, 2, 4, 128, 0.25),
        BlockDef("ir", 9, 3, 1, 6, 160, 0.25),
        BlockDef("ir", 15, 3, 2, 6, 256, 0.25),
    ),
)
_V2_M = (
    24,
    (
        BlockDef("cn", 3, 3, 1, 1, 24),
        BlockDef("er", 5, 3, 2, 4, 48),
        BlockDef("er", 5, 3, 2, 4, 80),
        BlockDef("ir", 7, 3, 2, 4, 160, 0.25),
        BlockDef("ir", 14, 3, 1, 6, 176, 0.25),
        BlockDef("ir", 18, 3, 2, 6, 304, 0.25),
        BlockDef("ir", 5, 3, 1, 6, 512, 0.25),
    ),
)
_V2_L = (
    32,
    (
        BlockDef("cn", 4, 3, 1, 1, 32),
        BlockDef("er", 7, 3, 2, 4, 64),
        BlockDef("er", 7, 3, 2, 4, 96),
        BlockDef("ir", 10, 3, 2, 4, 192, 0.25),
        BlockDef("ir", 19, 3, 1, 6, 224, 0.25),
        BlockDef("ir", 25, 3, 2, 6, 384, 0.25),
        BlockDef("ir", 7, 3, 1, 6, 640, 0.25),
    ),
)
# minimal stand-in arch (same stage kinds and 5 feature taps as b0)
_V2_TINY = (
    8,
    (
        BlockDef("cn", 1, 3, 1, 1, 8),
        BlockDef("er", 1, 3, 2, 2, 8),
        BlockDef("er", 1, 3, 2, 2, 16),
        BlockDef("ir", 1, 3, 2, 2, 16, 0.25),
        BlockDef("ir", 1, 3, 2, 2, 24, 0.25),
    ),
)

# name -> (stem, stages, channel_multiplier, depth_multiplier)
EFFNETV2_ARCHS: dict[str, tuple[int, tuple[BlockDef, ...], float, float]] = {
    "efficientnetv2_tiny": (*_V2_TINY, 1.0, 1.0),
    "efficientnetv2_b0": (*_V2_BASE, 1.0, 1.0),
    "efficientnetv2_b1": (*_V2_BASE, 1.0, 1.1),
    "efficientnetv2_b2": (*_V2_BASE, 1.1, 1.2),
    "efficientnetv2_b3": (*_V2_BASE, 1.2, 1.4),
    "efficientnetv2_s": (*_V2_S, 1.0, 1.0),
    "efficientnetv2_m": (*_V2_M, 1.0, 1.0),
    "efficientnetv2_l": (*_V2_L, 1.0, 1.0),
}


def round_channels(channels: float, multiplier: float = 1.0, divisor: int = 8) -> int:
    """timm-compatible channel rounding (make_divisible with 0.9 round limit)."""
    channels *= multiplier
    new = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new < 0.9 * channels:
        new += divisor
    return int(new)


def round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(repeats * multiplier))


def resolve_arch(name: str) -> tuple[int, list[BlockDef]]:
    """Apply width/depth multipliers → concrete (stem_channels, stages)."""
    key = name.replace("tf_", "").split(".")[0]
    if key not in EFFNETV2_ARCHS:
        raise KeyError(f"Unknown EfficientNetV2 arch: {name!r}")
    stem, stages, cm, dm = EFFNETV2_ARCHS[key]
    stem = round_channels(stem, cm)
    resolved = [
        dataclasses.replace(
            b,
            channels=round_channels(b.channels, cm),
            repeats=round_repeats(b.repeats, dm),
        )
        for b in stages
    ]
    return stem, resolved


def stem_kernel_to_s2d(kernel_hwio):
    """Transform a (3, 3, C, O) stride-2 stem kernel into the equivalent
    (2, 2, 4C, O) kernel for the space-to-depth stem (exact: output i of the
    k3 s2 SAME conv reads input rows 2i..2i+2, i.e. s2d blocks i, i+1 with a
    zero 4th tap). Copy of the JAX package's numpy function; channel
    ``dy·2C + dx·C + c`` of the s2d input is pixel (dy, dx) of channel c."""
    import numpy as np

    k = np.asarray(kernel_hwio)
    kh, kw, c, o = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"stem_kernel_to_s2d needs a 3x3 stem kernel, got {k.shape}")
    k4 = np.zeros((4, 4, c, o), k.dtype)
    k4[:3, :3] = k
    new = np.zeros((2, 2, 4 * c, o), k.dtype)
    for py in range(2):
        for px in range(2):
            for dy in range(2):
                for dx in range(2):
                    ch = dy * 2 * c + dx * c
                    new[py, px, ch : ch + c] = k4[2 * py + dy, 2 * px + dx]
    return new


def stem_weight_to_s2d(weight: torch.Tensor) -> torch.Tensor:
    """``stem_kernel_to_s2d`` on a port stem weight: (O, C, 3, 3) →
    (O, 4C, 2, 2), float32."""
    hwio = weight.detach().cpu().float().numpy().transpose(2, 3, 1, 0)
    return torch.from_numpy(stem_kernel_to_s2d(hwio).transpose(3, 2, 0, 1).copy())


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, 4C, H/2, W/2), channel ``dy·2C + dx·C + c`` =
    pixel (2i + dy, 2j + dx) of channel c: the JAX stem's
    ``reshape(b, h/2, 2, w/2, 2, c).transpose(0, 1, 3, 2, 4, 5)`` order
    (``F.pixel_unshuffle`` orders (c, dy, dx) instead). An odd H or W
    raises, as JAX's reshape does."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"the space-to-depth stem needs an even height and width, got {h}x{w}")
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Module):
    """Bias-free 2D conv with TF "SAME" padding; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        top, bottom = same_pad(x.shape[-2], k, self.stride)
        left, right = same_pad(x.shape[-1], k, self.stride)
        if (top, left) == (bottom, right):
            padding = (top, left)
        else:  # asymmetric: F.conv2d pads symmetrically, so pad explicitly
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, padding,
                        groups=self.groups)


class PointwiseConv(nn.Module):
    """1×1 (or 1×1×1) conv on channels-last input as a matmul over the last
    axis; weight (out, in, 1, 1[, 1]) as the conv's state layout."""

    def __init__(self, in_ch: int, out_ch: int, ndim: int = 2, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch) + (1,) * ndim))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.flatten(1).to(x.dtype), bias)


class BatchNormAct(nn.Module):
    """BN (+ optional activation) over the channel axis, with Flax's
    semantics.

    In eval mode the normalize runs in float32 with the running statistics —
    ``(x - mean)·(rsqrt(var + eps)·scale) + bias`` — and the result is cast
    back to the input dtype before the activation. In training mode the
    statistics are the batch's, in float32 over every axis but the channel
    axis, with Flax's fast biased variance ``E[x²] − E[x]²`` clipped at 0,
    and the running statistics move as ``0.9·running + 0.1·batch`` (Flax
    momentum 0.9; ``nn.BatchNorm`` would use the unbiased variance there).
    Under a ``torch.distributed`` process group the batch statistics are
    those of the global batch (``_global_batch_stats``), as JAX computes them
    over its data-parallel mesh; ``nn.SyncBatchNorm`` would bring torch's
    unbiased variance and momentum with it.
    ``folded=True`` is the BN-folded form (see ``models/fold_bn.py``): the
    scale lives in the preceding conv and only a per-channel ``bias`` is
    left; it is inference-only. ``channels_last`` says whether channels are
    the last axis (else axis 1, NCHW)."""

    momentum = 0.9

    def __init__(self, channels: int, act: Optional[Callable] = F.silu,
                 eps: float = 1e-3, folded: bool = False, channels_last: bool = False):
        super().__init__()
        self.act = act
        self.eps = eps
        self.folded = folded
        self.channels_last = channels_last
        self.bias = nn.Parameter(torch.zeros(channels))
        if not folded:
            self.weight = nn.Parameter(torch.ones(channels))
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def _shape(self, x: torch.Tensor) -> tuple[int, ...]:
        if self.channels_last:
            return (-1,)
        return (-1,) + (1,) * (x.dim() - 2)

    def _batch_stats(self, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dims = (tuple(range(xf.dim() - 1)) if self.channels_last
                else (0,) + tuple(range(2, xf.dim())))
        if in_process_group():
            mean, var = _global_batch_stats(xf, dims)
        else:
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = self._shape(x)
        if self.folded:
            if self.training:
                raise ValueError("a folded BatchNormAct is inference-only")
            x = x + self.bias.to(x.dtype).view(shape)
        else:
            xf = x.float()
            if self.training:
                mean, var = self._batch_stats(xf)
            else:
                mean, var = self.running_mean, self.running_var
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (xf - mean.view(shape)) * mul.view(shape)
            x = (y + self.bias.view(shape)).to(x.dtype)
        return x if self.act is None else self.act(x)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the process group whose gradient is the sum of the
    processes' gradients: each process's loss depends on every process's
    input through the sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _global_batch_stats(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """The statistics of the global batch across the process group: each
    process's float32 sums of x and x² over ``dims``, summed by a
    differentiable all-reduce, so that the gradient sees the global
    statistics, as GSPMD gives them to the JAX package. Every process has
    the same count of rows (the trainer pads a short batch)."""
    count = math.prod(xf.shape[d] for d in dims) * dist.get_world_size()
    sums = _AllReduceSum.apply(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]))
    mean = sums[0] / count
    var = (sums[1] / count - mean * mean).clamp_min(0.0)
    return mean, var


class DropPath(nn.Module):
    """Stochastic depth over the batch axis in training mode: each sample's
    residual branch is kept with probability 1 - rate and scaled by
    1/(1 - rate). Its mask is drawn from ``generator``, which the train step
    sets (``set_dropout_generator``)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = random_keep_mask(self.generator, shape, keep, x.device, self.shard)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Elementwise dropout in training mode (Flax ``nn.Dropout``), with its
    mask drawn from ``generator``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = random_keep_mask(self.generator, x.shape, keep, x.device, self.shard)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def random_keep_mask(generator: Optional[torch.Generator], shape, keep: float,
                     device: torch.device,
                     shard: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """A keep mask of ``shape`` drawn from ``generator``. ``shard`` =
    (process index, process count) in a data-parallel step: the mask is
    drawn for the global batch, whose leading axis is the processes' equal
    local batches one after another, and this process's rows are taken, so
    that the step draws what one process would on the global batch."""
    if generator is None:
        raise ValueError("dropout in training mode needs a generator: call "
                         "set_dropout_generator(model, generator) first")
    if shard is None:
        return torch.rand(shape, generator=generator, device=device) < keep
    index, count = shard
    full = torch.rand((count * shape[0],) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[index * shape[0]:(index + 1) * shape[0]] < keep


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator],
                          shard: Optional[tuple[int, int]] = None) -> None:
    """Give every ``DropPath`` and ``Dropout`` of ``model`` the generator of
    its masks and, in a data-parallel step, this process's (index, count)
    (``random_keep_mask``)."""
    for module in model.modules():
        if isinstance(module, (DropPath, Dropout)):
            module.generator = generator
            module.shard = shard


class SqueezeExcite2d(nn.Module):
    """SE over spatial dims; ``rd_channels`` derives from the *block input*
    channels (EfficientNet convention), not the expanded width."""

    def __init__(self, channels: int, rd_channels: int, act: Callable = F.silu):
        super().__init__()
        self.act = act
        self.conv_reduce = nn.Conv2d(channels, rd_channels, 1, bias=True)
        self.conv_expand = nn.Conv2d(rd_channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.mean(dim=(2, 3), keepdim=True)
        dt = x.dtype
        se = F.conv2d(se, self.conv_reduce.weight.to(dt), self.conv_reduce.bias.to(dt))
        se = self.act(se)
        se = F.conv2d(se, self.conv_expand.weight.to(dt), self.conv_expand.bias.to(dt))
        return x * torch.sigmoid(se)


class ConvBnAct(nn.Module):
    def __init__(self, in_ch: int, channels: int, kernel: int, stride: int,
                 act: Callable = F.silu, bn_eps: float = 1e-3, bn_folded: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.has_skip = stride == 1 and in_ch == channels
        self.conv = Conv2dSame(in_ch, channels, kernel, stride)
        self.bn1 = BatchNormAct(channels, act, bn_eps, bn_folded)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv(x))
        return self.drop_path(out) + x if self.has_skip else out


class EdgeResidual(nn.Module):
    """Fused-MBConv: kxk expansion conv → BN/act → 1x1 project → BN."""

    def __init__(self, in_ch: int, channels: int, kernel: int, stride: int,
                 expand: int, act: Callable = F.silu, bn_eps: float = 1e-3,
                 bn_folded: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.has_skip = stride == 1 and in_ch == channels
        self.conv_exp = Conv2dSame(in_ch, mid, kernel, stride)
        self.bn1 = BatchNormAct(mid, act, bn_eps, bn_folded)
        self.conv_pwl = Conv2dSame(mid, channels, 1)
        self.bn2 = BatchNormAct(channels, None, bn_eps, bn_folded)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv_pwl(self.bn1(self.conv_exp(x))))
        return self.drop_path(out) + x if self.has_skip else out


class InvertedResidual2d(nn.Module):
    """MBConv: 1x1 expand → dw kxk → SE → 1x1 project, all BN'd."""

    def __init__(self, in_ch: int, channels: int, kernel: int, stride: int,
                 expand: int, se_ratio: float, act: Callable = F.silu,
                 bn_eps: float = 1e-3, bn_folded: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.has_skip = stride == 1 and in_ch == channels
        self.conv_pw = Conv2dSame(in_ch, mid, 1)
        self.bn1 = BatchNormAct(mid, act, bn_eps, bn_folded)
        self.conv_dw = Conv2dSame(mid, mid, kernel, stride, groups=mid)
        self.bn2 = BatchNormAct(mid, act, bn_eps, bn_folded)
        self.se = (SqueezeExcite2d(mid, max(1, int(in_ch * se_ratio)), act)
                   if se_ratio > 0 else None)
        self.conv_pwl = Conv2dSame(mid, channels, 1)
        self.bn3 = BatchNormAct(channels, None, bn_eps, bn_folded)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv_dw(self.bn1(self.conv_pw(x))))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(self.conv_pwl(out))
        return self.drop_path(out) + x if self.has_skip else out


class EfficientNetV2Features(nn.Module):
    """Features-only EfficientNetV2 trunk: (B, C_in, H, W) → the activation
    at reduction boundary ``out_index`` (0..4 ↔ strides 2..32). Stages past
    the tap are never built. Block ``i`` (counted over every stage of the
    arch) drops paths at ``drop_path_rate·i/total_blocks``.
    ``stem_space_to_depth`` folds each 2×2 pixel block into channels
    (``space_to_depth``) and runs the stem as a 2×2 stride-1 SAME conv on
    4·C_in channels, whose weight ``stem_weight_to_s2d`` gives from a
    standard stem's: the same function."""

    bn_eps = 1e-3  # TF-ported weights; read by models/fold_bn.py

    def __init__(self, model_name: str = "efficientnetv2_b0", out_index: int = 4,
                 in_chans: int = 3, act: Callable = F.silu, bn_folded: bool = False,
                 drop_path_rate: float = 0.0, stem_space_to_depth: bool = False):
        super().__init__()
        stem_ch, stages = resolve_arch(model_name)
        total_blocks = sum(s.repeats for s in stages)
        last_stage = self._tap_stages(stages)[out_index]
        eps = self.bn_eps
        self.stem_space_to_depth = stem_space_to_depth
        if stem_space_to_depth:
            self.conv_stem = Conv2dSame(4 * in_chans, stem_ch, 2, 1)
        else:
            self.conv_stem = Conv2dSame(in_chans, stem_ch, 3, 2)
        self.bn1 = BatchNormAct(stem_ch, act, eps, bn_folded)
        self.block_names: list[str] = []
        in_ch = stem_ch
        for stage_idx, stage in enumerate(stages[: last_stage + 1]):
            for rep in range(stage.repeats):
                stride = stage.stride if rep == 0 else 1
                dpr = drop_path_rate * len(self.block_names) / total_blocks
                common = dict(in_ch=in_ch, channels=stage.channels, kernel=stage.kernel,
                              stride=stride, act=act, bn_eps=eps, bn_folded=bn_folded,
                              drop_path_rate=dpr)
                if stage.kind == "cn":
                    block = ConvBnAct(**common)
                elif stage.kind == "er":
                    block = EdgeResidual(expand=stage.expand, **common)
                elif stage.kind == "ir":
                    block = InvertedResidual2d(expand=stage.expand,
                                               se_ratio=stage.se_ratio, **common)
                else:
                    raise ValueError(stage.kind)
                name = f"blocks_{stage_idx}_{rep}"
                self.add_module(name, block)
                self.block_names.append(name)
                in_ch = stage.channels

    @staticmethod
    def feature_channels(model_name: str, out_index: int) -> int:
        """Channel count at a feature tap."""
        _, stages = resolve_arch(model_name)
        taps = EfficientNetV2Features._tap_stages(stages)
        return stages[taps[out_index]].channels

    @staticmethod
    def _tap_stages(stages: Sequence[BlockDef]) -> list[int]:
        """Map feature index → index of the last stage at that reduction."""
        taps: list[int] = []
        for i, stage in enumerate(stages):
            if stage.stride > 1 and i > 0:
                taps.append(i - 1)
        taps.append(len(stages) - 1)
        return taps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_space_to_depth:
            x = space_to_depth(x)
        x = self.bn1(self.conv_stem(x))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
