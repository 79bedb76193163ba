"""End-to-end training pipeline for one experiment stage (port of the JAX
package's ``train/pipeline.py``): annotations → sampling weights (with
optional out-of-fold hard negatives) → datasets and loaders → Trainer → fit,
plus the cross-stage pretrain resolution."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ball_action_spotting_torch.core import annotations as ann
from ball_action_spotting_torch.core.indexes import FrameIndexShaker, StackIndexesGenerator
from ball_action_spotting_torch.core.sampling import (
    action_sampling_weights,
    ball_sampling_weights,
)
from ball_action_spotting_torch.core.spotting import load_raw_predictions
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data.dataset import TrainClipDataset, ValClipDataset
from ball_action_spotting_torch.data.loader import ClipLoader
from ball_action_spotting_torch.data.video import make_sequential_factory
from ball_action_spotting_torch.domains.base import Domain
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.ops.mixup import make_mixup_fn
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.train.checkpoint import (
    get_best_checkpoint_path,
    resolve_pretrain_variables,
)
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.utils.experiments import num_decode_workers


def oof_predictions_path(domain: Domain, experiment: str, game: str, half: int,
                         game2fold: dict) -> Path:
    """Out-of-fold raw prediction npz location."""
    return (domain.predictions_dir / experiment / "cv" / f"fold_{game2fold[game]}"
            / game / f"{half}_raw_predictions.npz")


def build_sampling_weights(videos_data: list[dict], config: dict, domain: Domain,
                           game2fold: Optional[dict] = None) -> list[np.ndarray]:
    sw = dict(config["train_sampling_weights"])
    if "action_weights" in sw:
        return [action_sampling_weights(v, sw["action_window_size"], sw["action_prob"],
                                        sw["action_weights"])
                for v in videos_data]
    pred_experiment = sw.get("pred_experiment", "")
    weights = []
    for video in videos_data:
        oof_idx = oof_pred = None
        if pred_experiment:
            path = oof_predictions_path(domain, pred_experiment, video["game"],
                                        video["half"], game2fold or {})
            oof_idx, oof_pred = load_raw_predictions(path)
        weights.append(ball_sampling_weights(
            video, sw["action_window_size"], sw["action_prob"],
            sw["clear_pred_window_size"], oof_frame_indexes=oof_idx,
            oof_predictions=oof_pred))
    return weights


def build_datasets(config: dict, domain: Domain, train_games: Sequence[str],
                   val_games: Sequence[str], game2fold: Optional[dict] = None,
                   video_info_fn=None, videos_data: Optional[tuple] = None,
                   base_seed: int = 0):
    """→ (train_dataset, val_dataset). ``videos_data`` = (train, val) lists
    overrides annotation loading for synthetic runs."""
    ap = config["argus_params"]
    indexes_generator = StackIndexesGenerator(ap["frame_stack_size"], ap["frame_stack_step"])
    target_proc = MaxWindowTargetsProcessor(config["max_targets_window_size"])
    shaker = (FrameIndexShaker(**config["frame_index_shaker"])
              if config.get("frame_index_shaker") else None)
    if videos_data is not None:
        train_data, val_data = videos_data
    else:
        train_data = ann.get_videos_data(train_games, domain, video_info_fn=video_info_fn)
        val_data = ann.get_videos_data(val_games, domain, empty_actions=True,
                                       video_info_fn=video_info_fn)
    weights = build_sampling_weights(train_data, config, domain, game2fold)
    image_size = tuple(ap["image_size"])
    train_dataset = TrainClipDataset(
        train_data, list(domain.classes), indexes_generator, target_proc,
        image_size=image_size, epoch_size=config["train_epoch_size"],
        videos_sampling_weights=weights, frame_index_shaker=shaker, base_seed=base_seed,
    )
    # validation enumerates actions in video order: a rolling buffer over a
    # codec source decodes each frame once (stores pass through unwrapped)
    val_buffer = ap["frame_stack_size"] * ap["frame_stack_step"] * 2
    val_dataset = ValClipDataset(val_data, list(domain.classes), indexes_generator,
                                 target_proc, image_size=image_size,
                                 source_factory=make_sequential_factory(val_buffer))
    return train_dataset, val_dataset


def resolve_stage_pretrain(config: dict, domain: Domain, fold,
                           action_domain: Optional[Domain] = None) -> Optional[dict]:
    """Stage-pretrain weights: an action experiment's best checkpoint, or
    the same fold of a ball experiment."""
    pretrain_dir = None
    if config.get("pretrain_action_experiment"):
        if action_domain is None:
            raise ValueError("pretrain_action_experiment needs the action domain")
        pretrain_dir = action_domain.experiments_dir / config["pretrain_action_experiment"]
    elif config.get("pretrain_ball_experiment"):
        pretrain_dir = (domain.experiments_dir / config["pretrain_ball_experiment"]
                        / f"fold_{fold}")
    if not pretrain_dir:
        return None
    path = get_best_checkpoint_path(pretrain_dir)
    if path is None:
        raise FileNotFoundError(f"No pretrain checkpoint in {pretrain_dir}")
    print(f"Load pretrain model: {path}")
    variables, _ = resolve_pretrain_variables(path)
    return variables


def train_stage(config: dict, domain: Domain, save_dir: Path,
                train_games: Sequence[str], val_games: Sequence[str],
                game2fold: Optional[dict] = None,
                pretrain_variables: Optional[dict] = None,
                video_info_fn=None, videos_data=None, seed: int = 0,
                max_saves: int = 1, device: str | torch.device = "cuda") -> dict:
    """One full stage-set training run (warmup + train) for one fold. Under
    a process group of several processes each loader reads the process's
    rows of the global batches (``multihost.BatchShard``)."""
    train_dataset, val_dataset = build_datasets(
        config, domain, train_games, val_games, game2fold,
        video_info_fn=video_info_fn, videos_data=videos_data, base_seed=seed,
    )
    print(f"Train dataset len {len(train_dataset)}")
    print(f"Val dataset len {len(val_dataset)}")
    batch = config["batch_size"]
    if multihost.in_multihost():
        # each process reads its rows of every global batch
        train_dataset = multihost.BatchShard(train_dataset, batch)
        val_dataset = multihost.BatchShard(val_dataset, batch)
        batch = multihost.local_batch_size(batch)
    workers = num_decode_workers(config)
    train_loader = ClipLoader(train_dataset, batch, num_workers=workers)
    val_loader = ClipLoader(val_dataset, batch, num_workers=workers)
    trainer = Trainer(config, list(domain.classes), save_dir, augment=AugmentConfig(),
                      mixup=make_mixup_fn(config.get("mixup_params")), seed=seed,
                      max_saves=max_saves, device=device)
    trainer.init_state(pretrain_variables)
    return trainer.fit(train_loader, val_loader)
