"""Optimizers from reference-style config tuples (port of the JAX
package's ``train/optim.py``).

Configs name torch optimizers (``"optimizer": ("AdamW", {...})``), which the
JAX package maps onto optax with the same semantics; here they are torch's
own: AdamW with eps outside the square root and decoupled weight decay on
every parameter (optax ``adamw``), Adam, and SGD whose weight decay is added
to the gradient before the (Nesterov) momentum (optax
``add_decayed_weights`` then ``trace``). The rate is set before every step
from the schedule, so the ``lr`` of the config is not read here.

``freeze_conv2d_encoder`` leaves the 2D encoder's parameters out of the
optimizer and out of autograd: they get no update and no decay, while its
BN running statistics still move in training mode.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def _adamw(params, lr: float = 0.0, weight_decay: float = 1e-2, betas=(0.9, 0.999),
           eps: float = 1e-8) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=0.0, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _adam(params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if weight_decay:  # optax adamw, decoupled
        return _adamw(params, weight_decay=weight_decay, betas=betas, eps=eps)
    return torch.optim.Adam(params, lr=0.0, betas=tuple(betas), eps=eps)


def _sgd(params, lr: float = 0.0, momentum: float = 0.0, nesterov: bool = False,
         weight_decay: float = 0.0) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=nesterov,
                           weight_decay=weight_decay)


OPTIMIZER_REGISTRY: dict[str, Callable[..., torch.optim.Optimizer]] = {
    "AdamW": _adamw,
    "Adam": _adam,
    "SGD": _sgd,
}


def trainable_parameters(model: torch.nn.Module,
                         freeze_conv2d_encoder: bool = False) -> Iterable[torch.nn.Parameter]:
    """The parameters the optimizer updates; with the freeze, the encoder's
    parameters stop requiring gradients."""
    if freeze_conv2d_encoder:
        model.conv2d_encoder.requires_grad_(False)
    return [p for p in model.parameters() if p.requires_grad]


def build_optimizer(name: str, kwargs: dict, model: torch.nn.Module,
                    freeze_conv2d_encoder: bool = False) -> torch.optim.Optimizer:
    params = trainable_parameters(model, freeze_conv2d_encoder)
    return OPTIMIZER_REGISTRY[name](params, **kwargs)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
