"""Training state (port of the JAX package's ``train/state.py``): the step
count, the model, the optimizer, and an EMA shadow of the model's
parameters *and* BN running statistics, updated after each step as
``ema ← decay·ema + (1 − decay)·new``."""

from __future__ import annotations

import copy

import torch


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.ema = copy.deepcopy(model).requires_grad_(False).eval()

    @torch.no_grad()
    def ema_update(self, decay: float) -> None:
        ema = list(self.ema.parameters()) + list(self.ema.buffers())
        raw = list(self.model.parameters()) + list(self.model.buffers())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [t.detach() for t in raw], alpha=1.0 - decay)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, blob: dict) -> None:
        self.step = int(blob["step"])
        self.model.load_state_dict(blob["model"])
        self.ema.load_state_dict(blob["ema"])
        self.optimizer.load_state_dict(blob["optimizer"])
