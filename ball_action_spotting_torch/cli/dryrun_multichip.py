"""The multi-device dryrun (port of ``__graft_entry__.py::dryrun_multichip``):
one train step of a slim MultiDimStacker per parallel layout, and one
fold-parallel inference pass, over ``n`` devices.

    python -m ball_action_spotting_torch.cli.dryrun_multichip --devices 4 [--device cpu]

The legs, as JAX's (``n`` the device count):

- **dp**: ``n`` processes, one per device, over NCCL on the cards or gloo on
  the CPU, each taking its rows of one global batch (``train/steps.py``);
- **dp × tp** (``n`` ≥ 4, even): ``n/2`` processes, each splitting its
  state over its grid row's two devices with ``min_channels=64``
  (``parallel/sharding_rules.py``);
- **dp × sp** (``n`` ≥ 4, even): ``n/2`` processes, each cutting its rows'
  frames into height bands over its grid row's two devices (spatial
  partitioning, ``parallel/spatial.py``), no augmentation or mixup, as
  JAX's leg;
- **dp × pp** (``n`` ≥ 4, even): one process, a (``n/2``, 2) grid, the
  2-stage GPipe step with ``n_micro=2`` (``parallel/pipeline.py``);
- **fused fold-parallel inference** (``n`` ≥ 2): ``FusedFoldsPredictor``
  with 2 folds on a 1 × min(4, ``n``) grid.

Each leg prints ``dryrun_multichip OK: ...`` with its grid and its step
loss (or predictions) and seconds. The model is the slim one of
JAX's dryrun (the tiny encoder at 32×48, the flagship's block kinds and
split forward), in bfloat16 on the cards and float32 on the CPU, from
seeded weights. ``--device cpu`` lays the grids over the CPU device
repeated ``n`` times; by default they take the first ``n`` CUDA devices,
which must exist.
"""

from __future__ import annotations

import argparse
import socket
import tempfile
import time
from pathlib import Path
from queue import Empty

import numpy as np
import torch
import torch.multiprocessing as mp

from ball_action_spotting_torch.convert import state_dict_to_flax_tree
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models import build_model, init_train_weights
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import make_mesh, spatial_bands
from ball_action_spotting_torch.parallel.pipeline import make_pp_train_step, place_stages
from ball_action_spotting_torch.parallel.sharding_rules import shard_state
from ball_action_spotting_torch.parallel.spatial import bands_of
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.streaming import iter_source_frames
from ball_action_spotting_torch.train.checkpoint import save_checkpoint
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.schedules import warmup_cosine
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step

SLIM_NN_KWARGS = dict(  # __graft_entry__.py's _SLIM_NN_KWARGS
    model_name="efficientnetv2_tiny",
    num_classes=2,
    num_frames=6,
    stack_size=3,
    index_2d_features=4,
    num_3d_blocks=1,
    num_3d_features=64,
    expansion_3d_ratio=2,
    se_reduce_3d_ratio=8,
    num_3d_stack_proj=64,
    drop_rate=0.2,
    drop_path_rate=0.2,
    act_layer="silu",
)
HEIGHT, WIDTH = 32, 48
TP_MIN_CHANNELS = 64  # the slim model's widest tensors are 64-channel
N_MICRO = 2
SEED = 0


def devices_for(n: int, device: str) -> list[torch.device]:
    if n < 1:
        raise ValueError(f"the dryrun needs at least one device, got {n}")
    if device == "cpu":
        return [torch.device("cpu")] * n
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"the dryrun over {n} devices needs {n} CUDA devices, found "
                           f"{torch.cuda.device_count()}; pass --device cpu to lay the grids "
                           "over the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def _dtype(devices) -> torch.dtype:
    return torch.bfloat16 if devices[0].type == "cuda" else torch.float32


def slim_state(devices, stages=None, seed: int = SEED) -> TrainState:
    """The slim model's train state on ``devices[0]``, or with its
    pipeline stages placed on ``stages``."""
    model = build_model("multidim_stacker", dtype=_dtype(devices), **SLIM_NN_KWARGS)
    init_train_weights(model, torch.Generator().manual_seed(seed))
    if stages is None:
        model.to(devices[0])
    else:
        place_stages(model, stages)
    return TrainState(model, build_optimizer("AdamW", {}, model))


def _step_fn(**kwargs):
    return dict(loss_fn=FocalLoss(alpha=-1.0, gamma=1.2),
                schedule=warmup_cosine(3e-4, 3e-6, warmup_steps=2, cosine_steps=8),
                ema_decay=0.999, **kwargs)


def global_batch(rows: int) -> tuple[np.ndarray, np.ndarray]:
    frames = np.random.default_rng(0).integers(0, 255, (rows, 6, HEIGHT, WIDTH), dtype=np.uint8)
    targets = np.random.default_rng(1).random((rows, 2)).astype(np.float32)
    return frames, targets


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _train_worker(rank: int, world: int, port: int, kind: str, devices: list,
                  queue) -> None:
    """One process of the dp, dp × tp or dp × sp leg: its grid row, its
    rows of the global batch (dp × sp: cut into height bands over the row),
    one data-parallel step; rank 0 reports the loss."""
    n_model = len(devices) // world
    row = devices[rank * n_model:(rank + 1) * n_model]
    cuda = row[0].type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    multihost.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank,
                         backend="nccl" if cuda else "gloo", timeout_s=300)
    try:
        if cuda:
            torch.cuda.set_device(row[0])
        state = slim_state(row)
        if kind == "dp x tp":
            state = shard_state(state, make_mesh(world, n_model, devices),
                                min_channels=TP_MIN_CHANNELS, row=rank)
        frames, targets = global_batch(2 * world)
        rows = slice(2 * rank, 2 * rank + 2)
        local = torch.from_numpy(frames[rows])
        x = (bands_of(local, *spatial_bands(make_mesh(world, n_model, devices), local.shape[2],
                                            rank), axis=2)
             if kind == "dp x sp" else local.to(row[0]))
        aux = make_train_step(**_step_fn())(
            state, x, torch.from_numpy(targets[rows]).to(row[0]), SEED)
        loss = float(aux["loss"])
        if rank == 0:
            queue.put(loss)
    finally:
        multihost.shutdown()


def process_leg(kind: str, devices: list, world: int) -> float:
    """Run ``world`` processes of the dp, dp × tp or dp × sp leg; rank 0's
    loss."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_train_worker, args=(r, world, port, kind, devices, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    loss, deadline = None, time.monotonic() + 600
    try:
        while loss is None:  # the queue is drained before the joins
            try:
                loss = queue.get(timeout=1.0)
            except Empty:
                if any(p.exitcode for p in procs) or time.monotonic() > deadline:
                    break
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if loss is None or any(codes):
        raise RuntimeError(f"the {kind} leg's processes exited with {codes}")
    return loss


def pp_leg(devices: list) -> float:
    n_data = len(devices) // 2
    mesh = make_mesh(n_data, 2, devices[:2 * n_data])
    state = slim_state(devices, stages=mesh.model_devices(0))
    frames, targets = global_batch(n_data * 2)
    aux = make_pp_train_step(**_step_fn(mesh=mesh, n_micro=N_MICRO))(
        state, torch.from_numpy(frames).to(devices[0]), torch.from_numpy(targets).to(devices[0]),
        SEED)
    return float(aux["loss"])


def fused_leg(devices: list) -> tuple[int, int]:
    """2 fold checkpoints on a 1 × min(4, n) grid's model axis; (predictions,
    folds)."""
    n_model = min(4, len(devices))
    mesh = make_mesh(1, n_model, devices[:n_model])
    params = {"nn_module": ("multidim_stacker", dict(SLIM_NN_KWARGS)),
              "frame_stack_size": 6, "frame_stack_step": 2,
              "frames_processor": ("pad_normalize", {"size": (WIDTH, HEIGHT)})}
    n_frames = 24
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = []
        for i in range(2):
            model = build_model("multidim_stacker", **SLIM_NN_KWARGS)
            init_train_weights(model, torch.Generator().manual_seed(10 + i))
            path = Path(tmp) / f"model-00{i}-0.50000{i}.ckpt"
            save_checkpoint(path, params, state_dict_to_flax_tree(model.state_dict(), model))
            ckpts.append(path)
        pred = FusedFoldsPredictor(ckpts, dtype=_dtype(devices), chunk_size=8, mesh=mesh,
                                   fold_parallel=True)
        src = SyntheticSource(num_frames=n_frames, height=HEIGHT, width=WIDTH, seed=0,
                              events={10: 0})
        idx, raw = pred.predict_video(iter_source_frames(src), n_frames)
    if raw.shape != (len(idx), len(ckpts), 2) or not len(idx) or not np.isfinite(raw).all():
        raise RuntimeError(f"fused fold-parallel predictions of shape {raw.shape} "
                           f"over {len(idx)} indexes")
    return len(idx), len(ckpts)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[dict]:
    """Every leg over ``n_devices`` devices; returns a row per leg."""
    t_start = time.perf_counter()
    devices = devices_for(n_devices, device)
    legs = [("dp", n_devices, 1)]
    if n_devices >= 4 and n_devices % 2 == 0:
        legs += [("dp x tp", n_devices // 2, 2), ("dp x sp", n_devices // 2, 2),
                 ("dp x pp", n_devices // 2, 2)]
    rows = []
    for kind, n_data, n_model in legs:
        t_leg = time.perf_counter()
        mesh = f"mesh (data={n_data}, model={n_model}) [{kind}]"
        loss = pp_leg(devices) if kind == "dp x pp" else process_leg(kind, devices, n_data)
        if not np.isfinite(loss):
            raise RuntimeError(f"the {kind} leg's step loss is {loss}")
        seconds = time.perf_counter() - t_leg
        print(f"dryrun_multichip OK: {mesh}, step loss {loss:.4f}, leg {seconds:.1f}s",
              flush=True)
        rows.append({"leg": kind, "ok": True, "loss": loss, "seconds": seconds})
    if n_devices >= 2:
        t_leg = time.perf_counter()
        n_preds, folds = fused_leg(devices)
        seconds = time.perf_counter() - t_leg
        print(f"dryrun_multichip OK: mesh (data=1, model={min(4, n_devices)}) "
              f"[fused fold_parallel inference], {n_preds} preds x {folds} folds, "
              f"leg {seconds:.1f}s", flush=True)
        rows.append({"leg": "fused fold_parallel", "ok": True, "predictions": n_preds,
                     "seconds": seconds})
    print(f"dryrun_multichip total {time.perf_counter() - t_start:.1f}s", flush=True)
    return rows


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=None,
                        help="device count (default: every visible CUDA device)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda" else 1)
    return dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
