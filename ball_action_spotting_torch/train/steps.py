"""Train / val / predict steps (port of the JAX package's
``train/steps.py``).

A train step: uint8 frames → float32 /255 → augmentation (sampled, then
applied: the warp kernel and the photometric ops) → optional mixup →
forward in training mode (batch-statistic BN, dropout, drop path) → focal
loss in float32 → backward → optimizer step at the scheduled rate → EMA.
``iter_size`` splits the batch into microbatches whose gradients are
averaged; the BN running statistics carry from one microbatch to the next.

Every random draw of a step comes from generators seeded by (seed, step):
a CPU generator for the per-clip augmentation values and mixup, and one on
the frames' device for the noise, dropout and drop-path masks. A resumed
run therefore draws what an uninterrupted one would have.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ball_action_spotting_torch.models.effnetv2 import set_dropout_generator
from ball_action_spotting_torch.ops.augment import (
    AugmentConfig,
    apply_augment,
    sample_augment_params,
)
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.train.optim import set_lr
from ball_action_spotting_torch.train.schedules import Schedule
from ball_action_spotting_torch.train.state import TrainState


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 in [0, 1]."""
    return frames.float() / 255.0


def step_generators(seed: int, step: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(host, device) generators of one step, seeded by (seed, step)."""
    host_seed, device_seed = np.random.SeedSequence([seed, step]).generate_state(2)
    host = torch.Generator().manual_seed(int(host_seed))
    dev = torch.Generator(device=device).manual_seed(int(device_seed))
    return host, dev


def make_train_step(
    loss_fn: Callable,
    schedule: Schedule,
    ema_decay: float,
    augment: Optional[AugmentConfig] = None,
    mixup: Optional[Mixup] = None,
    iter_size: int = 1,
):
    """Returns ``train_step(state, frames_u8, targets, seed) -> aux``, which
    updates ``state`` in place. aux holds the mean loss and the sigmoid
    predictions and targets for the host-side epoch metrics."""

    def prepare(frames, targets, host_gen, dev_gen):
        x = normalize_frames(frames)
        if augment is not None:
            b, t, h, w = x.shape
            params = sample_augment_params(host_gen, dev_gen, b, t, h, w, augment)
            x = apply_augment(x, params, augment)
        if mixup is not None:
            x, targets = mixup.apply(x, targets, mixup.sample(host_gen, *x.shape[-2:]))
        return x, targets

    def train_step(state: TrainState, frames: torch.Tensor, targets: torch.Tensor,
                   seed: int) -> dict:
        model = state.model.train()
        b = frames.shape[0]
        if b % iter_size:
            raise ValueError(f"batch {b} is not a multiple of iter_size {iter_size}")
        micro = b // iter_size
        host_gen, dev_gen = step_generators(seed, state.step, frames.device)
        set_dropout_generator(model, dev_gen)
        set_lr(state.optimizer, schedule(state.step))
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=frames.device)
        outs, tgts = [], []
        for i in range(iter_size):
            part = slice(i * micro, (i + 1) * micro)
            x, tgt = prepare(frames[part], targets[part], host_gen, dev_gen)
            out = model(x)
            loss = loss_fn(out, tgt)
            (loss / iter_size).backward()
            loss_sum += loss.detach()
            outs.append(out.detach())
            tgts.append(tgt)
        state.optimizer.step()
        state.step += 1
        state.ema_update(ema_decay)
        return {
            "loss": loss_sum / iter_size,
            "prediction": torch.sigmoid(torch.cat(outs).float()),
            "target": torch.cat(tgts),
        }

    return train_step


def make_val_step(loss_fn: Callable, use_ema: bool = True):
    """val_step(state, frames_u8, targets) -> aux, on the EMA weights."""

    def val_step(state: TrainState, frames: torch.Tensor, targets: torch.Tensor) -> dict:
        model = (state.ema if use_ema else state.model).eval()
        with torch.inference_mode():
            out = model(normalize_frames(frames))
            return {
                "loss": loss_fn(out, targets),
                "prediction": torch.sigmoid(out.float()),
                "target": targets,
            }

    return val_step


def make_predict_step(use_ema: bool = True):
    def predict_step(state: TrainState, frames: torch.Tensor) -> torch.Tensor:
        model = (state.ema if use_ema else state.model).eval()
        with torch.inference_mode():
            return torch.sigmoid(model(normalize_frames(frames)).float())

    return predict_step
