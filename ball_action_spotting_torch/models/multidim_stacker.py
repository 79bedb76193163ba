"""MultiDimStacker — the flagship slow-fusion 2.5D+3D spotting model (port
of the JAX package's ``models/multidim_stacker.py``).

Consecutive ``stack_size`` frames form the channels of a shared 2D encoder;
the per-stack feature maps are fused across stacks by 3D inverted-residual
blocks, re-projected per stack, GeM-pooled and classified. The split methods
keep the JAX layouts at their boundaries:

  forward_2d       (B, T, H, W) frames → (B, T/stack, h, w, C3d)
  forward_2d_nhwc  (B, H, W, stack) stacks → (B, h, w, C3d)
  forward_3d       (B, T', h, w, C3d) → (B, h, w, T'·proj), stack-major
  forward_head     (B, h, w, F) → (B, num_classes) logits
  forward_3d_head  (B, T', h, w, C3d) → (B, num_classes) logits

``dtype`` is the compute dtype (bfloat16 on the card, float32 for parity
tests); parameters are stored in float32 and cast where they are used. GeM
returns float32, so the classifier runs in float32.

Each method also takes its input cut into height bands
(``parallel/spatial.py::Bands``, spatial partitioning) and returns bands,
with the height at the same place in each layout; the head pools the bands
(``gem_pool_bands``) and runs dropout and the classifier once, on the first
band's device.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ball_action_spotting_torch.models.blocks3d import (
    GeneralizedMeanPooling,
    InvertedResidual3d,
)
from ball_action_spotting_torch.models.effnetv2 import (
    BatchNormAct,
    Dropout,
    EfficientNetV2Features,
    PointwiseConv,
)
from ball_action_spotting_torch.parallel.spatial import Bands, device_of
from ball_action_spotting_torch.utils import profiling

_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "mish": F.mish,
}

# Projection norms use torch BatchNorm defaults, unlike the TF-ported
# encoder; models/fold_bn.py folds with this same constant.
PROJECTION_BN_EPS = 1e-5


class MultiDimStacker(nn.Module):
    """See module docstring. Constructor args mirror the JAX module's, so a
    checkpoint's ``nn_module`` kwargs build the same model. In training
    mode ``drop_rate`` is the dropout before the classifier and
    ``drop_path_rate`` the stochastic depth of the encoder (scaled by block
    index) and of every 3D block (in full); their masks come from the
    generator that ``set_dropout_generator`` gives the model.
    ``stem_space_to_depth`` builds the encoder with the space-to-depth stem
    and ``conv2d_int8`` with the int8 block convs
    (``effnetv2.py::EfficientNetV2Features``); the projection conv and the
    3D head stay in the compute dtype."""

    def __init__(
        self,
        model_name: str = "efficientnetv2_b0",
        num_classes: int = 2,
        num_frames: int = 15,
        stack_size: int = 3,
        index_2d_features: int = 4,
        num_3d_blocks: int = 2,
        num_3d_features: int = 192,
        num_3d_stack_proj: int = 256,
        expansion_3d_ratio: int = 6,
        se_reduce_3d_ratio: int = 24,
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        act_layer: str = "silu",
        dtype: torch.dtype = torch.float32,
        bn_folded: bool = False,
        dw3d_use_kernel: bool = False,
        stem_space_to_depth: bool = False,
        conv2d_int8: bool = False,
    ):
        super().__init__()
        if num_frames <= 0 or num_frames % stack_size:
            raise ValueError(f"num_frames {num_frames} is not a multiple of "
                             f"stack_size {stack_size}")
        act = _ACTS[act_layer]
        self.num_classes = num_classes
        self.num_frames = num_frames
        self.stack_size = stack_size
        self.num_3d_features = num_3d_features
        self.num_3d_stack_proj = num_3d_stack_proj
        self.dtype = dtype
        self.dw3d_use_kernel = dw3d_use_kernel
        enc_ch = EfficientNetV2Features.feature_channels(model_name, index_2d_features)

        self.conv2d_encoder = EfficientNetV2Features(
            model_name, index_2d_features, in_chans=self.encoder_in_chans(), act=act,
            bn_folded=bn_folded, drop_path_rate=drop_path_rate,
            stem_space_to_depth=stem_space_to_depth, conv_int8=conv2d_int8,
        )
        self.conv2d_projection_conv = PointwiseConv(enc_ch, num_3d_features)
        self.conv2d_projection_bn = BatchNormAct(
            num_3d_features, act, PROJECTION_BN_EPS, bn_folded, channels_last=True)
        self.num_3d_blocks = num_3d_blocks
        for i in range(num_3d_blocks):
            self.add_module(f"conv3d_encoder_{i}", InvertedResidual3d(
                num_3d_features, expansion_ratio=expansion_3d_ratio,
                se_reduce_ratio=se_reduce_3d_ratio, act=act, bn_folded=bn_folded,
                dw_use_kernel=dw3d_use_kernel, drop_path_rate=drop_path_rate,
            ))
        self.conv3d_projection_conv = PointwiseConv(num_3d_features, num_3d_stack_proj)
        self.conv3d_projection_bn = BatchNormAct(
            num_3d_stack_proj, act, PROJECTION_BN_EPS, bn_folded, channels_last=True)
        self.global_pool = GeneralizedMeanPooling(3.0)
        self.dropout = Dropout(drop_rate)
        self.classifier = nn.Linear(num_3d_stack_proj * self.num_stacks, num_classes)

    def encoder_in_chans(self) -> int:
        return self.stack_size

    @property
    def num_stacks(self) -> int:
        return self.num_frames // self.stack_size

    @property
    def num_features(self) -> int:
        return self.num_3d_stack_proj * self.num_stacks

    def _encode(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        # (B, stack, H, W) → (B, h, w, C3d) channels-last
        x = self.conv2d_encoder(x).permute(0, 2, 3, 1)
        return self.conv2d_projection_bn(self.conv2d_projection_conv(x))

    def forward_2d(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        """(B, T, H, W) frames → (B, T/stack, h, w, C3d) per-stack features."""
        b, t, h, w = x.shape
        num_stacks = t // self.stack_size
        if isinstance(x, Bands):
            x = self._encode(x.map(lambda p: p.to(self.dtype).reshape(
                b * num_stacks, self.stack_size, p.shape[2], w)))
            return x.map(lambda p: p.reshape((b, num_stacks) + p.shape[1:]), axis=2)
        x = x.to(self.dtype).reshape(b * num_stacks, self.stack_size, h, w)
        x = self._encode(x)
        return x.reshape((b, num_stacks) + x.shape[1:])

    def forward_2d_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, stack_size) channels-last stacks → (B, h, w, C3d). Same
        parameters and values as ``forward_2d``; the permute is a view, so
        the encoder sees channels-last memory."""
        assert x.shape[-1] == self.stack_size
        if isinstance(x, Bands):
            return self._encode(x.map(lambda p: p.to(self.dtype)).permute(0, 3, 1, 2))
        return self._encode(x.to(self.dtype).permute(0, 3, 1, 2))

    def _blocks_3d(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        # (B, T', h, w, C) → the 3D blocks' output per stack, (B·T', h, w, C),
        # in a ``head.blocks3d`` span timed on x's device; counts the stack
        # maps (``head_stacks``)
        b, t, h, w, c = x.shape
        assert c == self.num_3d_features and t == self.num_stacks
        profiling.count("head_stacks", b * t)
        with profiling.span("head.blocks3d", device=device_of(x)):
            for i in range(self.num_3d_blocks):
                x = getattr(self, f"conv3d_encoder_{i}")(x)
        if isinstance(x, Bands):
            return x.map(lambda p: p.reshape(b * t, p.shape[2], w, c), axis=1)
        return x.reshape(b * t, h, w, c)

    def _project(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        # per-stack (B·T', h, w, C) → (B·T', h, w, proj)
        return self.conv3d_projection_bn(self.conv3d_projection_conv(x))

    def forward_3d(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        """(B, T', h, w, C) stack features → (B, h, w, T'·proj) fused map,
        stacks concatenated on channels stack-major."""
        b, t, h, w, _ = x.shape
        proj = self.num_3d_stack_proj
        if isinstance(x, Bands):
            return self._project(self._blocks_3d(x)).map(lambda p: p.reshape(
                b, t, p.shape[1], w, proj).permute(0, 2, 3, 1, 4).reshape(
                b, p.shape[1], w, t * proj))
        x = self._project(self._blocks_3d(x)).reshape(b, t, h, w, self.num_3d_stack_proj)
        return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * self.num_3d_stack_proj)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.dropout(self.global_pool(x)))

    def forward_3d_head(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T', h, w, C) stack features → (B, num_classes) logits:
        ``forward_head(forward_3d(x))`` with GeM pooled per stack and the
        pooled vectors flattened stack-major, the same channel order. The
        projection, GeM and the classifier run in a ``head.pool`` span."""
        b, t = x.shape[:2]
        x = self._blocks_3d(x)
        with profiling.span("head.pool", device=device_of(x)):
            x = self.global_pool(self._project(x))  # (b·t, proj) float32
            return self.classifier(self.dropout(x.reshape(b, t * self.num_3d_stack_proj)))

    def forward(self, x: torch.Tensor | Bands) -> torch.Tensor:
        feats = self.forward_2d(x)
        if isinstance(feats, Bands):  # logits on the first band's device
            return self.forward_head(self.forward_3d(feats))
        # a pipeline-placed model (parallel/pipeline.py::place_stages) holds
        # forward_3d's modules on another device than forward_2d's; the
        # logits come back to the input's device, beside its targets
        feats = feats.to(self.conv3d_projection_bn.bias.device)
        return self.forward_head(self.forward_3d(feats)).to(x.device)
