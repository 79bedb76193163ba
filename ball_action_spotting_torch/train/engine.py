"""Training engine: the fit loop (port of the JAX package's
``train/engine.py`` without its tensor- and pipeline-parallel code).

Builds the model, loss, optimizer and schedule from a reference-style
config dict, runs the warmup and train stages as one fused rate schedule,
accumulates per-class metrics on the host, logs each epoch to
``log.txt``/``log.csv``, checkpoints the best-by-val-AP EMA weights as
``BASTPU01`` ``.ckpt`` files (which both packages' predictors read) and
keeps a resume point after every epoch.

Under a ``torch.distributed`` process group (``parallel/multihost.py``, one
process per device, launched by ``torchrun``) the trainer is data parallel
as the JAX trainer is across hosts: each process's loader yields its local
rows of the config's global ``batch_size`` (``multihost.local_batch_size``,
``multihost.BatchShard``); a batch with fewer rows on some process is
padded to the largest by cycling its rows; every process must run the same
number of steps, and unequal counts raise on every process before the first
step; validation outputs are gathered and the padding rows dropped from the
epoch metrics; only the primary process writes ``log.txt``, ``log.csv``,
checkpoints and the resume point.
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
from ball_action_spotting_torch.models.pretrained import apply_pretrained_encoder
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.ops.losses import build_loss
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import pad_batch_to_devices
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


def _setup_file_logging(save_dir: Path, to_file: bool = True) -> logging.Logger:
    lg = logging.getLogger(f"bas_torch.train.{save_dir}")
    lg.setLevel(logging.INFO)
    lg.handlers.clear()
    save_dir.mkdir(parents=True, exist_ok=True)
    if to_file:  # under a process group only the primary owns log.txt
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

    def __init__(self, path: Path, write: bool = True):
        self.path = Path(path)
        self.write = write
        self._rows: list[dict] = []
        self._fieldnames: list[str] = []

    def log(self, row: dict) -> None:
        self._rows.append(dict(row))
        for key in row:
            if key not in self._fieldnames:
                self._fieldnames.append(key)
        if not self.write:
            return
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
        self._nproc = multihost.process_count()
        self._primary = multihost.is_primary()
        self.logger = _setup_file_logging(self.save_dir, to_file=self._primary)
        self.csv_logger = CsvLogger(self.save_dir / "log.csv", write=self._primary)
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
        """Model weights from the seed (Flax's initializers), then either
        transferred from a prior stage's checkpoint tree or, with
        ``pretrained`` in the model kwargs, the encoder's from the ImageNet
        weight file (``models/pretrained.py``; a missing file raises); then
        the optimizer and EMA. A stage pretrain supersedes the ImageNet
        init, as in the reference."""
        nn_name, nn_kwargs = self.config["argus_params"]["nn_module"]
        model = build_model(nn_name, dtype=self.compute_dtype, **nn_kwargs)
        init_train_weights(model, torch.Generator().manual_seed(self.seed))
        if pretrain_variables is not None:
            state = ckpt_lib.transfer_weights(
                model.state_dict(), flax_tree_to_state_dict(pretrain_variables))
            model.load_state_dict(state)
        elif nn_kwargs.get("pretrained", False):
            encoder_name = ("encoder" if nn_name in ("timm", "classifier2d")
                            else "conv2d_encoder")
            state = apply_pretrained_encoder(
                model.state_dict(), nn_kwargs["model_name"], encoder_name=encoder_name,
                stem_space_to_depth=bool(nn_kwargs.get("stem_space_to_depth", False)))
            model.load_state_dict(state)
            self.logger.info(f"Initialized {encoder_name} from ImageNet-pretrained "
                             f"{nn_kwargs['model_name']}")
        model.to(self.device)
        opt_name, opt_kwargs = self.optimizer_spec
        optimizer = build_optimizer(opt_name, opt_kwargs, model, self.freeze_conv2d_encoder)
        self.state = TrainState(model, optimizer)
        return self.state

    # --- epochs -----------------------------------------------------------

    def _device_batches(self, loader, epoch: int):
        """Yields (frames, targets, valid) on the device. Under a process
        group each batch is padded, by cycling its rows, to the largest
        count any process has for that step; ``valid`` is this process's
        count of real rows."""
        iterator = loader.epoch(epoch) if hasattr(loader, "epoch") else iter(loader)
        valids: list[int] = []

        def padded():
            for frames, targets in iterator:
                valid = frames.shape[0]
                if self._nproc > 1:
                    most = int(multihost.allgather(valid).max())
                    frames, targets, valid = pad_batch_to_devices(frames, targets, most)
                valids.append(valid)
                yield frames, targets

        for frames, targets in prefetch_to_device(padded(), self.device):
            yield frames, targets, valids.pop(0)

    def _assert_equal_steps(self, loader, what: str) -> None:
        """Every process must make the same number of steps, each of which
        joins the others in collectives: one process waiting at a step the
        others never reach hangs them all. Compare the loaders' lengths up
        front and raise on every process instead."""
        if self._nproc <= 1:
            return
        try:
            local = len(loader)
        except TypeError:
            raise TypeError(f"{what} under a process group needs a sized loader "
                            "(len(loader)), so that equal step counts can be checked "
                            "before the first collective") from None
        counts = multihost.allgather(local).reshape(-1)
        if len({int(c) for c in counts}) > 1:
            raise RuntimeError(
                f"{what}: unequal per-process batch counts {counts.tolist()} would hang "
                "the process group at the first missing collective. Shard the data "
                "with multihost.BatchShard (or process_slice_even) so that every "
                "process makes the same number of steps")

    def train_epoch(self, loader, epoch: int) -> dict:
        if self.state is None:
            raise RuntimeError("call init_state first")
        self._assert_equal_steps(loader, "train_epoch")
        losses = []
        t0 = time.time()
        n = 0
        for frames, targets, valid in self._device_batches(loader, epoch):
            aux = self.train_step(self.state, frames, targets, self.seed + 1)
            losses.append(aux["loss"])
            n += valid
        losses = [float(loss) for loss in losses]
        dt = time.time() - t0
        # every process steps together: the group's throughput is the sum
        n = int(multihost.allgather(n).sum()) if self._nproc > 1 else n
        return {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "train_samples_per_sec": n / dt if dt > 0 else 0.0,
        }

    def val_epoch(self, loader, epoch: int = 0) -> dict:
        if self.state is None:
            raise RuntimeError("call init_state first")
        self._assert_equal_steps(loader, "val_epoch")
        metrics = [AveragePrecision(self.classes),
                   Accuracy(self.classes, self.config.get("metric_accuracy_threshold", 0.5))]
        losses = []
        for frames, targets, valid in self._device_batches(loader, epoch):
            out = self.val_step(self.state, frames, targets)
            pred = out["prediction"].cpu().numpy()
            targ = out["target"].cpu().numpy()
            loss = float(out["loss"])
            if self._nproc > 1:
                # every process's rows, its padding rows dropped; the loss
                # of the padded global batch, as the JAX trainer's
                valids = multihost.allgather(valid).reshape(-1)
                preds, targs = multihost.allgather(pred), multihost.allgather(targ)
                pred = np.concatenate([p[:v] for p, v in zip(preds, valids)])
                targ = np.concatenate([t[:v] for t, v in zip(targs, valids)])
                loss = float(multihost.allgather(loss).mean())
            else:
                pred, targ = pred[:valid], targ[:valid]
            losses.append(loss)
            for m in metrics:
                m.update({"prediction": pred, "target": targ})
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
                if self._primary:  # one writer under a process group
                    self.ckpt_manager.save(epoch, score, self._params_dict(),
                                           self.variables(ema=True), self.variables(ema=False))
                if score > best.get(self.monitor, -np.inf):
                    best = dict(row)
            self.logger.info(" ".join(f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                                      for k, v in row.items()))
            self.csv_logger.log(row)
            if resume and self._primary:
                ckpt_lib.save_train_state(resume_path, self.state, epoch, best)
        multihost.barrier()  # every process has read the resume point
        if resume and self._primary and resume_path.exists() and epochs:
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
