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
run therefore draws what an uninterrupted one would have. Under a process
group the step is data parallel and equals one process's step on the
global batch (``make_train_step``). Frames cut into height bands
(``parallel/spatial.py::Bands``) make the step spatially partitioned: the
model runs on the bands and the gradients flow back through the windows
and the cross-band sums to the weights' device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ball_action_spotting_torch.models.effnetv2 import set_dropout_generator
from ball_action_spotting_torch.ops.augment import (
    AugmentConfig,
    apply_augment,
    sample_augment_params,
)
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.parallel.multihost import (
    global_batch_from_local,
    in_process_group,
    process_count,
    process_index,
)
from ball_action_spotting_torch.parallel.spatial import Bands
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


def average_gradients(model: torch.nn.Module, count: int) -> None:
    """Average the parameters' gradients over the process group: one
    all-reduce of every gradient flattened into one float32 buffer, on the
    first gradient's device (a tensor-parallel state's slices lie on
    several, ``parallel/sharding_rules.py``)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float().to(grads[0].device) for g in grads])
    dist.all_reduce(flat)
    flat /= count
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def prepare_batch(frames: torch.Tensor, targets: torch.Tensor, host_gen: torch.Generator,
                  dev_gen: torch.Generator, augment: Optional[AugmentConfig] = None,
                  mixup: Optional[Mixup] = None, shard: Optional[tuple[int, int]] = None):
    """One microbatch's uint8 frames → (augmented, mixed frames, targets):
    /255, the augmentation sampled from the step's generators and applied,
    then mixup. ``shard`` = (process index, count) in a data-parallel step:
    the draws are made for the global batch and this process takes its
    rows; mixup pairs rows across processes, so the augmented batch is
    gathered before it."""
    x = normalize_frames(frames)
    index, count = shard or (0, 1)
    b = x.shape[0]
    rows = slice(index * b, (index + 1) * b)
    if augment is not None:
        _, t, h, w = x.shape
        params = sample_augment_params(host_gen, dev_gen, count * b, t, h, w, augment)
        if shard is not None:
            params = {k: v[rows] for k, v in params.items()}
        x = apply_augment(x, params, augment)
    if mixup is not None:
        draw = mixup.sample(host_gen, *x.shape[-2:])
        if shard is None:
            x, targets = mixup.apply(x, targets, draw)
        else:
            x, targets = mixup.apply(global_batch_from_local(x),
                                     global_batch_from_local(targets), draw)
            x, targets = x[rows], targets[rows]
    return x, targets


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
    predictions and targets for the host-side epoch metrics.

    Under a ``torch.distributed`` process group the step is data parallel:
    each process passes its local rows, all of the same count, and the
    global batch is the processes' rows one after another. Every random
    draw is made for the global batch and each process takes its rows (the
    augmentation, the drop-path and dropout masks); mixup pairs rows across
    processes, so the augmented batch is gathered before it and each
    process keeps its rows of the mixed batch; the BatchNorm statistics are
    the global batch's (``models/effnetv2.py::BatchNormAct``); the gradients
    and the reported loss are averaged over the processes. The step then
    equals one process's step on the global batch. With ``iter_size`` > 1
    each microbatch's global batch is the processes' rows of that
    microbatch.

    ``frames`` may be (B, T, H, W) bands cut on axis 2 over a grid row's
    model-axis devices (spatial partitioning, as the JAX package's
    ``spatial_frames_sharding(mesh, 4, 2)``), with ``targets`` on the first
    band's device; such a step takes no augmentation, mixup or
    ``iter_size``, as the JAX package's dp × sp dryrun leg runs none. The
    draws, the BN statistics (over the bands, then the processes) and the
    loss are the unbanded step's."""

    def train_step(state: TrainState, frames: torch.Tensor | Bands, targets: torch.Tensor,
                   seed: int) -> dict:
        model = state.model.train()
        banded = isinstance(frames, Bands)
        if banded and (augment is not None or mixup is not None or iter_size != 1):
            raise ValueError("a step on frame bands takes no augmentation, mixup or iter_size")
        device = frames.devices[0] if banded else frames.device
        b = frames.shape[0]
        if b % iter_size:
            raise ValueError(f"batch {b} is not a multiple of iter_size {iter_size}")
        micro = b // iter_size
        shard = (process_index(), process_count()) if in_process_group() else None
        host_gen, dev_gen = step_generators(seed, state.step, device)
        set_dropout_generator(model, dev_gen, shard)
        set_lr(state.optimizer, schedule(state.step))
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=device)
        outs, tgts = [], []
        for i in range(iter_size):
            part = slice(i * micro, (i + 1) * micro)
            if banded:
                x, tgt = frames.map(normalize_frames), targets
            else:
                x, tgt = prepare_batch(frames[part], targets[part], host_gen, dev_gen, augment,
                                       mixup, shard)
            out = model(x)
            loss = loss_fn(out, tgt)
            (loss / iter_size).backward()
            loss_sum += loss.detach()
            outs.append(out.detach())
            tgts.append(tgt)
        if shard is not None:
            average_gradients(model, shard[1])
            dist.all_reduce(loss_sum)
            loss_sum /= shard[1]
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
