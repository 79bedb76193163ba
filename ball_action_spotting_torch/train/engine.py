"""Training engine: the fit loop on one device (port of the JAX package's
``train/engine.py`` without its mesh, pipeline-parallel and multihost code).

Builds the model, loss, optimizer and schedule from a reference-style
config dict, runs the warmup and train stages as one fused rate schedule,
accumulates per-class metrics on the host, logs each epoch to
``log.txt``/``log.csv``, checkpoints the best-by-val-AP EMA weights as
``BASTPU01`` ``.ckpt`` files (which both packages' predictors read) and
keeps a resume point after every epoch.
"""

from __future__ import annotations

import csv
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ball_action_spotting_torch.convert import flax_tree_to_state_dict, state_dict_to_flax_tree
from ball_action_spotting_torch.data.loader import prefetch_to_device
from ball_action_spotting_torch.device import resolve_device
from ball_action_spotting_torch.models import build_model, init_train_weights
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.ops.losses import build_loss
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.train import checkpoint as ckpt_lib
from ball_action_spotting_torch.train.metrics import Accuracy, AveragePrecision
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.schedules import get_lr, warmup_cosine
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import (
    make_predict_step,
    make_train_step,
    make_val_step,
)

RESUME_FILE = "train_state.pt"


def _setup_file_logging(save_dir: Path) -> logging.Logger:
    lg = logging.getLogger(f"bas_torch.train.{save_dir}")
    lg.setLevel(logging.INFO)
    lg.handlers.clear()
    save_dir.mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(save_dir / "log.txt")
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
    lg.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(message)s"))
    lg.addHandler(sh)
    lg.propagate = False
    return lg


class CsvLogger:
    """Per-epoch metric rows. Columns can grow between stages (warmup rows
    carry no val metrics), so the file is rewritten with the union of
    fieldnames."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._rows: list[dict] = []
        self._fieldnames: list[str] = []

    def log(self, row: dict) -> None:
        self._rows.append(dict(row))
        for key in row:
            if key not in self._fieldnames:
                self._fieldnames.append(key)
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(self._rows)


class Trainer:
    """Builds and fits one experiment stage set.

    ``config`` is a reference-style experiment dict (see ``configs/``);
    batches come from ``ClipLoader``-style iterables of (uint8 frames
    (B, T, H, W), float32 targets (B, C)). ``device`` defaults to CUDA and
    must exist; ``compute_dtype`` is the model's (bfloat16 on the card).
    """

    def __init__(
        self,
        config: dict,
        classes: list[str],
        save_dir: Path,
        augment: Optional[AugmentConfig] = None,
        mixup: Optional[Mixup] = None,
        steps_per_epoch: Optional[int] = None,
        max_saves: int = 1,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.classes = classes
        self.save_dir = Path(save_dir)
        self.logger = _setup_file_logging(self.save_dir)
        self.csv_logger = CsvLogger(self.save_dir / "log.csv")
        self.seed = seed
        self.compute_dtype = compute_dtype

        ap = config["argus_params"]
        self.loss = build_loss(ap["loss"][0], **ap["loss"][1])
        self.batch_size = config["batch_size"]
        self.image_size = tuple(ap["image_size"])  # (W, H)
        self.frame_stack_size = ap["frame_stack_size"]
        self.freeze_conv2d_encoder = bool(ap.get("freeze_conv2d_encoder", False))

        # one fused schedule over all stages (warmup → cosine); its length
        # is the batches the loader yields, by ceil division
        steps_per_epoch = steps_per_epoch or -(-config["train_epoch_size"] // config["batch_size"])
        self.steps_per_epoch = steps_per_epoch
        stages = list(zip(config["num_epochs"], config["stages"]))
        warmup_epochs = sum(n for n, s in stages if s == "warmup")
        train_epochs = sum(n for n, s in stages if s == "train")
        opt_name, opt_kwargs = ap["optimizer"]
        base_lr = opt_kwargs.get("lr", 1e-3)
        min_lr = get_lr(config.get("min_base_lr", 0.0), config["batch_size"])
        self.schedule = warmup_cosine(
            base_lr, max(min_lr, 1e-8),
            warmup_steps=warmup_epochs * steps_per_epoch,
            cosine_steps=max(1, train_epochs * steps_per_epoch),
        )
        self.optimizer_spec = (opt_name, {k: v for k, v in opt_kwargs.items() if k != "lr"})
        self.ema_decay = config.get("ema_decay", 0.999)
        self.train_step = make_train_step(
            self.loss, self.schedule, self.ema_decay, augment=augment, mixup=mixup,
            iter_size=int(ap.get("iter_size", 1)))
        self.val_step = make_val_step(self.loss)
        self.predict_step = make_predict_step()
        self.ckpt_manager = ckpt_lib.CheckpointManager(
            self.save_dir, max_saves=max_saves,
            tie_keep=config.get("checkpoint_tie_keep", "first"))
        self.monitor = "val_average_precision"
        self.state: Optional[TrainState] = None

    # --- state/initialization -------------------------------------------

    def init_state(self, pretrain_variables: Optional[dict] = None) -> TrainState:
        """Model weights from the seed (Flax's initializers), or transferred
        from a prior stage's checkpoint tree; then the optimizer and EMA."""
        nn_name, nn_kwargs = self.config["argus_params"]["nn_module"]
        if pretrain_variables is None and nn_kwargs.get("pretrained", False):
            raise NotImplementedError(
                "pretrained=True needs the ImageNet encoder weights "
                "(models/pretrained.py is not ported yet); use pretrained=False")
        model = build_model(nn_name, dtype=self.compute_dtype, **nn_kwargs)
        init_train_weights(model, torch.Generator().manual_seed(self.seed))
        if pretrain_variables is not None:
            # a prior stage's checkpoint supersedes the initialization
            state = ckpt_lib.transfer_weights(
                model.state_dict(), flax_tree_to_state_dict(pretrain_variables))
            model.load_state_dict(state)
        model.to(self.device)
        opt_name, opt_kwargs = self.optimizer_spec
        optimizer = build_optimizer(opt_name, opt_kwargs, model, self.freeze_conv2d_encoder)
        self.state = TrainState(model, optimizer)
        return self.state

    # --- epochs -----------------------------------------------------------

    def _device_batches(self, loader, epoch: int):
        iterator = loader.epoch(epoch) if hasattr(loader, "epoch") else iter(loader)
        return prefetch_to_device(iterator, self.device)

    def train_epoch(self, loader, epoch: int) -> dict:
        if self.state is None:
            raise RuntimeError("call init_state first")
        losses = []
        t0 = time.time()
        n = 0
        for frames, targets in self._device_batches(loader, epoch):
            aux = self.train_step(self.state, frames, targets, self.seed + 1)
            losses.append(aux["loss"])
            n += frames.shape[0]
        losses = [float(loss) for loss in losses]
        dt = time.time() - t0
        return {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "train_samples_per_sec": n / dt if dt > 0 else 0.0,
        }

    def val_epoch(self, loader, epoch: int = 0) -> dict:
        if self.state is None:
            raise RuntimeError("call init_state first")
        metrics = [AveragePrecision(self.classes),
                   Accuracy(self.classes, self.config.get("metric_accuracy_threshold", 0.5))]
        losses = []
        for frames, targets in self._device_batches(loader, epoch):
            out = self.val_step(self.state, frames, targets)
            losses.append(float(out["loss"]))
            step_output = {"prediction": out["prediction"].cpu().numpy(),
                           "target": out["target"].cpu().numpy()}
            for m in metrics:
                m.update(step_output)
        results = {"val_loss": float(np.mean(losses)) if losses else float("nan")}
        for m in metrics:
            results.update(m.results("val_"))
        return results

    # --- fit ---------------------------------------------------------------

    def fit(self, train_loader, val_loader=None, pretrain_variables=None,
            resume: bool = True) -> dict:
        """Run all configured stages; returns the best epoch's metrics.

        With ``resume=True`` an interrupted run restarts after the last
        completed epoch from ``train_state.pt`` in the experiment dir."""
        if self.state is None:
            self.init_state(pretrain_variables)
        resume_path = self.save_dir / RESUME_FILE
        best = {self.monitor: -np.inf}
        start_epoch = 0
        if resume and resume_path.exists():
            self.state, start_epoch, best = ckpt_lib.load_train_state(resume_path, self.state)
            self.logger.info(f"Resumed from {resume_path} at epoch {start_epoch}")

        epochs = [stage for num_epochs, stage in
                  zip(self.config["num_epochs"], self.config["stages"])
                  for _ in range(num_epochs)]
        for epoch, stage in enumerate(epochs):
            if epoch < start_epoch:
                continue
            row = {"epoch": epoch, "stage": stage}
            row.update(self.train_epoch(train_loader, epoch))
            if stage == "train" and val_loader is not None:
                row.update(self.val_epoch(val_loader, epoch))
                score = row.get(self.monitor, -np.inf)
                self.ckpt_manager.save(epoch, score, self._params_dict(),
                                       self.variables(ema=True), self.variables(ema=False))
                if score > best.get(self.monitor, -np.inf):
                    best = dict(row)
            self.logger.info(" ".join(f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                                      for k, v in row.items()))
            self.csv_logger.log(row)
            if resume:
                ckpt_lib.save_train_state(resume_path, self.state, epoch, best)
        if resume and resume_path.exists() and epochs:
            resume_path.unlink()  # run completed; drop the resume point
        return best

    def variables(self, ema: bool = True) -> dict:
        """The EMA (or raw) weights as the Flax variable tree of the JAX
        model."""
        model = self.state.ema if ema else self.state.model
        return state_dict_to_flax_tree(model.state_dict(), model)

    def _params_dict(self) -> dict:
        ap = dict(self.config["argus_params"])
        return {
            "nn_module": list(ap["nn_module"]),
            "loss": list(ap["loss"]),
            "optimizer": list(ap["optimizer"]),
            "image_size": list(self.image_size),
            "frame_stack_size": ap["frame_stack_size"],
            "frame_stack_step": ap["frame_stack_step"],
            "frames_processor": list(ap["frames_processor"]),
            "freeze_conv2d_encoder": self.freeze_conv2d_encoder,
        }
