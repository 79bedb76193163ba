"""Pipeline parallelism: the 2-stage GPipe train step over a grid's model
axis (port of the JAX package's ``parallel/pipeline.py``).

The MultiDimStacker splits along its own seam into two stages:

- stage 0: ``forward_2d``, the per-stack 2D encoder and its projection;
- stage 1: ``forward_3d`` + ``forward_head`` and the loss.

``place_stages`` puts a model's stage-0 modules on a data row's model-axis
device 0 and the rest on its device 1. The model's state_dict is the
unsplit one's, and its ``forward`` moves the activation from one stage's
device to the other's and returns the logits on the input's device, so
that evaluation, prediction and checkpoints work on the split model as on
one device.

``make_pp_train_step`` runs the train step in one process over a
(n_data, 2) ``DeviceMesh`` and issues ``n_micro`` microbatches in the
GPipe order: at tick t stage 0's work for microbatch t is queued, then
stage 1's for microbatch t − 1, each on its device's current stream. The
activation crosses with a non-blocking copy, which the copy itself orders
after stage 0's work on the source device, and the host does not
synchronize inside the schedule. One ``backward()`` over the whole graph
is the backward pass. The order allows the two devices to overlap, but
this schedule was measured not to: on four H100s, a step's two stage
cards were busy at the same time for about a thousandth of it
(PERF.md §6 and §7; overlapping them is ROADMAP B item 10).

Semantics (JAX's):

- BN normalizes one microbatch at a time, and its running statistics
  chain through the microbatches on the stage that owns the layer: pp with
  ``n_micro`` = M has the BN semantics of ``iter_size`` = M.
- Augmentation and mixup run per microbatch with the ``iter_size`` path's
  draws (``train/steps.py::prepare_batch``), so that pp(M) equals the
  ``iter_size`` = M step where dropout and drop path are off.
- With n_data > 1 data rows, each row holds a split copy of the model and
  runs its contiguous share of the (augmented) batch, cut into ``n_micro``
  microbatches. The loss is the mean over rows of ``loss_fn`` over the
  row's logits; the gradients average over the rows into row 0, whose
  optimizer steps; the running statistics' deltas average over the rows.
  The other rows take row 0's weights at the start of each step.
- Dropout and drop-path masks come from a generator on each stage's device,
  seeded by (seed, step, row, stage), not from the ``iter_size`` path's one
  generator: with them on, the two steps draw other masks (as JAX's
  pipeline draws other masks than its accumulation scan).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ball_action_spotting_torch.models.effnetv2 import set_dropout_generator
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.parallel.mesh import MODEL_AXIS, DeviceMesh
from ball_action_spotting_torch.parallel.multihost import in_process_group
from ball_action_spotting_torch.train.optim import set_lr
from ball_action_spotting_torch.train.schedules import Schedule
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import prepare_batch, step_generators

N_STAGES = 2  # forward_2d | forward_3d + head
STAGE0 = ("conv2d_encoder", "conv2d_projection_conv", "conv2d_projection_bn")


def check_stages(mesh: DeviceMesh) -> None:
    if mesh.shape[MODEL_AXIS] != N_STAGES:
        raise ValueError(
            f"pipeline needs model axis == {N_STAGES}, got {mesh.shape[MODEL_AXIS]}")


def stage_of(name: str) -> int:
    """The stage of the MultiDimStacker's child module ``name``."""
    return 0 if name in STAGE0 else 1


def place_stages(model: nn.Module, devices) -> nn.Module:
    """Move ``model``'s stage-0 modules to ``devices[0]`` and the others to
    ``devices[1]`` (in place; the parameters stay the same objects)."""
    for name, child in model.named_children():
        child.to(devices[stage_of(name)])
    return model


def _set_stage_generators(model: nn.Module, seed: int, step: int, row: int, devices) -> None:
    seeds = np.random.SeedSequence([seed, step, 1 + row]).generate_state(N_STAGES)
    gens = [torch.Generator(device=d).manual_seed(int(s)) for d, s in zip(devices, seeds)]
    for name, child in model.named_children():
        set_dropout_generator(child, gens[stage_of(name)])


def make_pp_forward_loss(loss_fn: Callable, mesh: DeviceMesh, n_micro: int):
    """Returns ``forward_loss(models, x, targets) -> (loss, logits)``, the
    pipelined forward of one step: ``models[r]`` is data row r's split copy
    of the model (``place_stages`` on ``mesh.model_devices(r)``), in
    training mode; ``x`` the normalized, augmented global batch
    (B, T, H, W) and ``targets`` its (B, classes), B divisible by
    n_data · n_micro. ``loss`` is a graph over every row's stages (call
    ``backward()`` on it, then ``reduce_gradients``); ``logits`` (B,
    classes) are in batch order on row 0's stage-1 device. The rows' BN
    running statistics are averaged into ``models[0]``."""
    check_stages(mesh)

    def forward_loss(models, x, targets):
        n_data = len(models)
        if n_data != mesh.shape["data"]:
            raise ValueError(f"{n_data} models for a data axis of {mesh.shape['data']}")
        rows = mesh.batch_slices(x.shape[0])
        local = rows[0].stop - rows[0].start
        if local % n_micro:
            raise ValueError(f"a row's {local} rows do not divide into {n_micro} microbatches")
        mb = local // n_micro
        devices = [mesh.model_devices(r) for r in range(n_data)]
        xs = [x[rows[r]].to(devices[r][0], non_blocking=True) for r in range(n_data)]
        outs: list[list[torch.Tensor]] = [[] for _ in range(n_data)]
        recv: list[Optional[torch.Tensor]] = [None] * n_data
        for t in range(n_micro + 1):
            sent: list[Optional[torch.Tensor]] = [None] * n_data
            if t < n_micro:
                for r, model in enumerate(models):
                    feats = model.forward_2d(xs[r][t * mb:(t + 1) * mb])
                    sent[r] = feats.to(devices[r][1], non_blocking=True)
            if t >= 1:
                for r, model in enumerate(models):
                    outs[r].append(model.forward_head(model.forward_3d(recv[r])))
            recv = sent
        out_device = devices[0][1]
        logits = [torch.cat(o) for o in outs]
        losses = [loss_fn(lg, targets[rows[r]].to(lg.device)).float().to(out_device)
                  for r, lg in enumerate(logits)]
        loss = torch.stack(losses).mean()
        merge_statistics(models)
        return loss, torch.cat([lg.to(out_device) for lg in logits])

    return forward_loss


@torch.no_grad()
def merge_statistics(models) -> None:
    """Row 0's floating buffers (the BN running statistics) become the
    mean over the rows: every row started the step from row 0's, so this is
    row 0's old value plus the rows' mean delta."""
    if len(models) == 1:
        return
    for bufs in zip(*(m.buffers() for m in models)):
        if bufs[0].is_floating_point():
            bufs[0].copy_(torch.stack([b.to(bufs[0].device) for b in bufs]).mean(0))


@torch.no_grad()
def reduce_gradients(models) -> None:
    """Sum the rows' gradients into row 0's: each row's loss entered the
    step's loss divided by the row count, so the sum is the rows' mean."""
    for params in zip(*(m.parameters() for m in models[1:]), models[0].parameters()):
        *others, p0 = params
        if p0.grad is None:
            continue
        for p in others:
            p0.grad += p.grad.to(p0.device)


@torch.no_grad()
def _sync_rows(models) -> None:
    """Rows 1.. take row 0's parameters and buffers."""
    for m in models[1:]:
        for dst, src in zip(m.parameters(), models[0].parameters()):
            dst.copy_(src)
            dst.grad = None
        for dst, src in zip(m.buffers(), models[0].buffers()):
            dst.copy_(src)


def make_pp_train_step(
    loss_fn: Callable,
    schedule: Schedule,
    ema_decay: float,
    mesh: DeviceMesh,
    n_micro: int,
    augment: Optional[AugmentConfig] = None,
    mixup: Optional[Mixup] = None,
):
    """The pipelined twin of ``train/steps.py::make_train_step``:
    ``train_step(state, frames_u8, targets, seed) -> aux``, updating
    ``state`` in place, the same optimizer step and EMA. ``state.model``
    must be placed on row 0 (``place_stages(model, mesh.model_devices(0))``)
    before its optimizer is built; the step keeps a split copy for every
    other data row. One process only: a process group raises."""
    check_stages(mesh)
    forward_loss = make_pp_forward_loss(loss_fn, mesh, n_micro)
    n_data = mesh.shape["data"]
    rows: dict = {}

    def row_models(model: nn.Module) -> list:
        if rows.get("model") is not model:
            set_dropout_generator(model, None)  # a generator cannot be copied
            rows["model"] = model
            rows["copies"] = [place_stages(copy.deepcopy(model), mesh.model_devices(r))
                              for r in range(1, n_data)]
        models = [model] + rows["copies"]
        _sync_rows(models)
        return models

    def train_step(state: TrainState, frames: torch.Tensor, targets: torch.Tensor,
                   seed: int) -> dict:
        if in_process_group():
            raise ValueError("pipeline_parallel runs in one process: its data axis is the "
                             "grid's rows, not a process group")
        model = state.model.train()
        stage0 = mesh.model_devices(0)[0]
        if next(model.conv2d_encoder.parameters()).device != stage0:
            raise ValueError(f"place the model's stages on {mesh.model_devices(0)} "
                             "(place_stages) before building its optimizer")
        b = frames.shape[0]
        if b % (n_data * n_micro):
            raise ValueError(f"batch {b} is not divisible by data axis {n_data} × "
                             f"n_micro {n_micro}")
        host_gen, dev_gen = step_generators(seed, state.step, frames.device)
        micro = b // n_micro
        xs, tgts = [], []
        for i in range(n_micro):
            part = slice(i * micro, (i + 1) * micro)
            x, tgt = prepare_batch(frames[part], targets[part], host_gen, dev_gen, augment, mixup)
            xs.append(x)
            tgts.append(tgt)
        x, targets = torch.cat(xs), torch.cat(tgts)
        models = row_models(model)
        for r, m in enumerate(models):
            m.train()
            _set_stage_generators(m, seed, state.step, r, mesh.model_devices(r))
        set_lr(state.optimizer, schedule(state.step))
        state.optimizer.zero_grad(set_to_none=True)
        loss, logits = forward_loss(models, x, targets)
        loss.backward()
        reduce_gradients(models)
        state.optimizer.step()
        state.step += 1
        state.ema_update(ema_decay)
        return {
            "loss": loss.detach(),
            "prediction": torch.sigmoid(logits.detach().float()),
            "target": targets,
        }

    return train_step
