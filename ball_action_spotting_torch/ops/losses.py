"""Losses (port of the JAX package's ``ops/focal_loss.py`` and
``ops/losses.py``): sigmoid focal loss and BCE with logits, computed in
float32 whatever the input dtype; configs name them through ``build_loss``."""

from __future__ import annotations

import dataclasses

import torch


def _bce_with_logits(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    # stable form: max(x, 0) - x·t + log(1 + exp(-|x|))
    return inputs.clamp_min(0.0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor, alpha: float = -1.0,
                       gamma: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    """RetinaNet focal loss; ``alpha < 0`` turns class balancing off."""
    inputs = inputs.float()
    targets = targets.float()
    p = torch.sigmoid(inputs)
    ce_loss = _bce_with_logits(inputs, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce_loss * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return _reduce(loss, reduction)


@dataclasses.dataclass(frozen=True)
class FocalLoss:
    alpha: float = -1.0
    gamma: float = 2.0
    reduction: str = "mean"

    def __call__(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return sigmoid_focal_loss(inputs, targets, self.alpha, self.gamma, self.reduction)


@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLoss:
    reduction: str = "mean"

    def __call__(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return _reduce(_bce_with_logits(inputs.float(), targets.float()), self.reduction)


LOSS_REGISTRY = {
    "focal_loss": FocalLoss,
    "BCEWithLogitsLoss": BCEWithLogitsLoss,
}


def build_loss(name: str, **kwargs):
    return LOSS_REGISTRY[name](**kwargs)
