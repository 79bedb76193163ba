"""One gloo process of the port's data-parallel training checks
(``tests/test_torch_parallel.py``), and the one-process runs they are held
to. It imports no JAX, so that a worker starts in seconds.

    python -m tests.torch_dp_worker MODE RANK WORLD PORT OUT_DIR

MODE ``step``: three train steps (augmentation, mixup and drop path on) on
this rank's rows of three seeded global batches; ``fit``: ``Trainer.fit``
on ``multihost.BatchShard`` loaders, writing into ``OUT_DIR/rank_R``, then
the final validation metrics against the same weights over the whole
validation set on this rank alone; ``unequal``: a train epoch with one more
batch on rank 1 than on rank 0; ``tp``: the ``step`` run (drop rates 0)
with its state split by ``parallel/sharding_rules.py::shard_state`` over
row RANK of a (WORLD, 2) grid of the CPU, beside the same run replicated.
Each writes ``OUT_DIR/MODE_R.pt``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.core.sampling import ball_sampling_weights
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data import (
    ClipLoader,
    TrainClipDataset,
    ValClipDataset,
    make_synthetic_video_data,
)
from ball_action_spotting_torch.models import build_model, init_train_weights
from ball_action_spotting_torch.models.effnetv2 import EFFNETV2_ARCHS, BlockDef
from ball_action_spotting_torch.ops.augment import AugmentConfig
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.parallel.sharding_rules import gathered, shard_state
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.train.metrics import AveragePrecision
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step

EFFNETV2_ARCHS["efficientnetv2_test"] = (  # the port's tiny arch (tests/tiny_arch.py)
    8,
    (BlockDef("cn", 1, 3, 1, 1, 8), BlockDef("er", 1, 3, 2, 2, 8),
     BlockDef("er", 1, 3, 2, 2, 16), BlockDef("ir", 1, 3, 2, 2, 16, 0.25),
     BlockDef("ir", 1, 3, 2, 2, 24, 0.25)),
    1.0, 1.0,
)
NN_KWARGS = dict(
    model_name="efficientnetv2_test", num_classes=2, num_frames=6, stack_size=3,
    index_2d_features=4, num_3d_blocks=1, num_3d_features=16, num_3d_stack_proj=16,
    expansion_3d_ratio=2, se_reduce_3d_ratio=4, drop_rate=0.1, drop_path_rate=0.2,
)
CLASSES = ["PASS", "DRIVE"]
GLOBAL_BATCH = 4
STEPS = 3
AUG = AugmentConfig(warp_precision="highest")
MIXUP = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5)
ADAM_EPS = 1e-3  # as tests/test_torch_train.py: rounding noise of zero gradients stays small
TP_MIN_CHANNELS = 16  # the tiny arch's widths are 8 to 48: most convs split


def global_batches():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, (GLOBAL_BATCH, 6, 64, 96), dtype=np.uint8),
             (rng.random((GLOBAL_BATCH, 2)) > 0.5).astype(np.float32)) for _ in range(STEPS)]


def step_run(rank: int = 0, world: int = 1, mixup: Mixup | None = MIXUP,
             drop: bool = True, sharded: bool = False) -> dict:
    """Three steps on this rank's rows of the global batches (all of them
    with ``world`` 1): the losses and the final parameters; ``sharded``
    splits the state over row ``rank`` of a (``world``, 2) grid first."""
    kwargs = NN_KWARGS if drop else dict(NN_KWARGS, drop_rate=0.0, drop_path_rate=0.0)
    model = build_model("multidim_stacker", **kwargs)
    init_train_weights(model, torch.Generator().manual_seed(5))
    state = TrainState(model, build_optimizer("AdamW", {"eps": ADAM_EPS}, model))
    if sharded:
        state = shard_state(state, make_mesh(world, 2, ["cpu"] * (2 * world)),
                            min_channels=TP_MIN_CHANNELS, row=rank)
    step = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda count: 1e-3, 0.9,
                           augment=AUG, mixup=mixup)
    local = GLOBAL_BATCH // world
    losses = []
    for frames, targets in global_batches():
        rows = slice(rank * local, (rank + 1) * local)
        aux = step(state, torch.from_numpy(frames[rows]), torch.from_numpy(targets[rows]), 7)
        losses.append(float(aux["loss"]))
    return {"losses": losses,
            "params": {k: v.detach().clone() for k, v in gathered(model.state_dict()).items()},
            "ema": {k: v.detach().clone() for k, v in gathered(state.ema.state_dict()).items()},
            "shards": sum(name.endswith(".0") for name, _ in model.named_parameters())}


def fit_config() -> dict:
    return dict(
        image_size=(96, 64), batch_size=GLOBAL_BATCH, base_lr=3e-3, min_base_lr=3e-5,
        ema_decay=0.9, max_targets_window_size=6, train_epoch_size=8,
        train_sampling_weights=dict(action_window_size=5, action_prob=0.5,
                                    pred_experiment="", clear_pred_window_size=5),
        metric_accuracy_threshold=0.5, num_decode_workers=1, num_epochs=[1, 1],
        stages=["warmup", "train"],
        argus_params={
            "nn_module": ("multidim_stacker", NN_KWARGS),
            "loss": ("focal_loss", {"alpha": -1.0, "gamma": 1.2, "reduction": "mean"}),
            "optimizer": ("AdamW", {"lr": 3e-3}),
            "image_size": (96, 64), "frame_stack_size": 6, "frame_stack_step": 2,
            "iter_size": 1, "frames_processor": ("pad_normalize", {"size": (96, 64)}),
            "freeze_conv2d_encoder": False,
        },
    )


def datasets():
    videos = make_synthetic_video_data(num_videos=2, num_frames=120, classes=CLASSES)
    weights = [ball_sampling_weights(v, 5, 0.5, 5) for v in videos]
    gen, tproc = StackIndexesGenerator(6, 2), MaxWindowTargetsProcessor(6)
    train_ds = TrainClipDataset(videos, CLASSES, gen, tproc, image_size=(96, 64), epoch_size=8,
                                videos_sampling_weights=weights, base_seed=3)
    # 7 validation clips: a trailing global batch of 3, 2 + 1 rows, the
    # second rank's padded to 2
    val_videos = make_synthetic_video_data(num_videos=1, num_frames=160, classes=CLASSES,
                                           every=20)
    val_ds = ValClipDataset(val_videos, CLASSES, gen, tproc, image_size=(96, 64))
    return train_ds, val_ds


def fit_run(out_dir: Path, rank: int) -> dict:
    train_ds, val_ds = datasets()
    local = multihost.local_batch_size(GLOBAL_BATCH)

    def loader(ds):
        return ClipLoader(multihost.BatchShard(ds, GLOBAL_BATCH), local, num_workers=1,
                          ordered=True)

    trainer = Trainer(fit_config(), CLASSES, out_dir / f"rank_{rank}", augment=AUG,
                      compute_dtype=torch.float32, device="cpu", seed=1)
    best = trainer.fit(loader(train_ds), loader(val_ds), resume=False)
    final = trainer.val_epoch(loader(val_ds))
    # the same weights over the whole validation set in this process alone
    ap = AveragePrecision(CLASSES)
    model = trainer.state.ema.eval()
    with torch.inference_mode():
        for frames, targets in ClipLoader(val_ds, GLOBAL_BATCH, num_workers=1, ordered=True):
            out = model(torch.from_numpy(np.asarray(frames)).float() / 255.0)
            ap.update({"prediction": torch.sigmoid(out).numpy(), "target": np.asarray(targets)})
    return {"best": best, "final": final, "whole": ap.results("val_"),
            "val_len": len(val_ds), "steps": trainer.state.step}


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def unequal_run(out_dir: Path, rank: int) -> dict:
    trainer = Trainer(fit_config(), CLASSES, out_dir / f"rank_{rank}", augment=AUG,
                      compute_dtype=torch.float32, device="cpu", seed=1)
    trainer.init_state()
    batches = [(frames[:2], targets[:2]) for frames, targets in global_batches()[:2 + rank]]
    try:
        trainer.train_epoch(ListLoader(batches), 0)
    except RuntimeError as err:
        return {"error": str(err)}
    return {"error": None}


def main(argv) -> None:
    mode, rank, world, port, out_dir = argv
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    torch.set_num_threads(1)
    multihost.initialize(f"tcp://localhost:{port}", world_size=int(world), rank=rank,
                         backend="gloo", timeout_s=120)
    try:
        if mode == "step":
            result = step_run(rank, world)
        elif mode == "tp":
            result = {"tp": step_run(rank, world, drop=False, sharded=True),
                      "replicated": step_run(rank, world, drop=False)}
        elif mode == "fit":
            result = fit_run(out_dir, rank)
        else:
            result = unequal_run(out_dir, rank)
        torch.save(result, out_dir / f"{mode}_{rank}.pt")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
