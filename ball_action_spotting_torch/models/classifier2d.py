"""Plain 2D encoder classifier, the model registry's ``"timm"`` and
``"classifier2d"`` entries (port of the JAX package's
``models/classifier2d.py``): an EfficientNetV2 encoder, global pooling
(average, or GeM through ``ops/gem.py``, the kernel on a CUDA tensor) and
a linear head, for 2D-baseline experiments.

Input (B, C, H, W) channels-first, or (B, H, W, C) with
``channels_last=True``. Module names follow the Flax scopes (``encoder``,
``global_pool``, ``classifier``), so ``convert.py`` maps one state onto
the other. Pooling and the head run in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ball_action_spotting_torch.models.blocks3d import GeneralizedMeanPooling
from ball_action_spotting_torch.models.effnetv2 import Dropout, EfficientNetV2Features
from ball_action_spotting_torch.models.multidim_stacker import _ACTS


class Classifier2d(nn.Module):
    def __init__(
        self,
        model_name: str = "efficientnetv2_b0",
        num_classes: int = 2,
        in_chans: int = 3,
        pool: str = "avg",
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        act_layer: str = "silu",
        channels_last: bool = False,
        dtype: torch.dtype = torch.float32,
        bn_folded: bool = False,
    ):
        super().__init__()
        if pool not in ("avg", "gem"):
            raise ValueError(f"pool must be 'avg' or 'gem', got {pool!r}")
        self.num_classes = num_classes
        self.channels_last = channels_last
        self.dtype = dtype
        self.encoder = EfficientNetV2Features(
            model_name, 4, in_chans=in_chans, act=_ACTS[act_layer], bn_folded=bn_folded,
            drop_path_rate=drop_path_rate)
        self.global_pool = GeneralizedMeanPooling(3.0) if pool == "gem" else None
        self.dropout = Dropout(drop_rate)
        self.classifier = nn.Linear(EfficientNetV2Features.feature_channels(model_name, 4),
                                    num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.channels_last:
            x = x.permute(0, 3, 1, 2)
        x = self.encoder(x)  # (B, C, h, w)
        if self.global_pool is not None:
            x = self.global_pool(x.permute(0, 2, 3, 1))  # float32
        else:
            x = x.float().mean(dim=(2, 3))
        return self.classifier(self.dropout(x))
