"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): kernels, the
flagship chunked inference path, the flagship training path, the rest of
the four-stage recipe with its evaluation, the serving path, the
fold-fused ensemble, the sealed export and the parallel paths, and the
weight sources and model families (ImageNet files, reference ``.pth``
checkpoints, the s2d stem, ``multichan_stacker``, ``classifier2d``).

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero; each prints its seconds):

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of ``ball_action_spotting_torch/csrc`` with nvcc (one process per
   source, all at once), printing the build time and ptxas' report.
2. Holds each kernel against its plain PyTorch version at the main paths'
   shapes, and times kernel, plain version and the one PyTorch call that
   computes the same function (CUDA events around the call, median of 10:
   ``kernel_ms``, what a caller pays) and the kernel's own device time
   (torch.profiler over 10 calls, median of per-call sums: ``device_ms``;
   ``direct_ms`` times the op's CUDA function called directly, without the
   ``torch.library`` dispatcher;
   the serving shapes' rows take each kernel's median over the launches
   the profiler saw, ``device_ms_method``). Prints one JSON
   line per kernel and shape with its bound on an H100 SXM. GeM at the
   inference head's and the train step's head's shapes in bf16, with its
   backward in float32 and bf16, and two runs bit-identical; the depthwise
   conv at the inference shapes in bf16; the warp resample at the train
   step's H-pass and V-pass shapes in bf16 and float32. Then the edge
   shapes: ``DW_EDGE_CASES`` (T 1, 2, 5; ragged and whole row tiles; W 1
   and 96; C 6, 96, 576; float32, bf16, fp16; an x off a 16-byte
   boundary), ``DW_ROUTE_CASES`` (odd C, N 65536, strided and misaligned
   x, widths past the staging limit through the grouped conv, each with
   its count of kernel launches), ``GEM_EDGE_CASES`` and
   ``WARP_EDGE_CASES`` (both load widths of each kernel, odd blocks,
   flips, fp16, a large B, N 1 with H 1).
3. Drives the flagship ``ChunkedVideoPredictor`` (EfficientNetV2-b0, 15
   frames, 1280x736, four 3D blocks at 576 channels, chunk 128, bf16,
   seeded random weights) over a synthetic video: hflip TTA on and off, the
   depthwise kernel on and off (off: the grouped ``conv3d``, named
   ``default`` in the checks), feature carry and frame carry. The main
   path (TTA on, kernel on, feature carry) runs with the launch counters
   set to 0 and must launch GeM and the depthwise conv. Checks the outputs,
   the spotting JSON, a float32 run against the plain batch forward, and
   prints fps.
4. Trains the flagship recipe at full width with the port's ``Trainer``
   (``pretrained=False``, batch 4, augmentation on, 1 warmup + 1 train
   epoch of 16 samples = 8 steps, synthetic 1280x736 videos), with the
   launch counters set to 0: every loss finite, 8 steps, the EMA apart from
   the raw weights, the warp kernel launched twice per step and GeM on
   every step, a best ``.ckpt`` that the port's predictor predicts from.
   Then ~10 steps on one fixed batch without augmentation, whose loss must
   drop, and one float32 step (TF32 off, tiny arch at 64x96, the same
   sampled augmentation) on the card against the same step on the CPU.
   Prints ms per train step, samples/s, augmentation ms, the device's idle
   share and top kernels of a step (torch.profiler) and peak memory.
5. Recipe and evaluation, at the flagship's full width on synthetic games
   written as gray stores (one ball game, fold 0's, and one action game;
   two halves of 160 frames at 1280x720 each): the training phase's best
   checkpoint is stage 1, whose fold-0 predictions (ball predict CLI) are
   the out-of-fold hard negatives of stage 3. Stage 2 trains
   ``action_sampling_weights_002`` (``pretrained=False``, 4 optimizer steps,
   1 val step) through the action train CLI's path; stage 3 trains
   ``ball_tuning_001`` (4 steps) from the action checkpoint through
   ``resolve_stage_pretrain``, every tensor but the classifier loaded. Its
   best checkpoint predicts the ball game (TTA on) with the depthwise kernel
   and without; each is scored at "at1" by both algorithms, against the
   game's labels and against labels at the kernel path's own spots (1.0 for
   the matcher, ≥ 0.99 official, the default path within ``MAP_ATOL``);
   the two are ensembled and zipped, and the zip must score as its
   directory. The action checkpoint predicts its game (TTA off, kernel on),
   scored at "tight". Each path runs with the launch counters set to 0.
6. Serving, at the flagship's full width (bf16, hflip TTA on, the
   engines' default route, which on the card is the depthwise kernel) on
   synthetic 1280x720 videos: GeM and the
   depthwise conv at the serving shapes against their plain versions; the
   per-frame ``StreamingPredictor`` against the chunked engine over 414
   frames (and in float32 over 160 frames); ``MultiStreamPredictor`` on 4
   live streams of 96 frames (staggered admission, a tick of 2 frames per
   stream, a ragged tick, a close that moves a slot and a reopen) against a
   ``StreamingPredictor`` per stream; ``DeviceStateMultiStreamPredictor``
   on the same feed against the host-state engine; the HTTP server
   (``predict/server.py``) with each engine, built and warmed as its CLI
   does, 4 client threads posting 96 frames each and polling until all 68
   predictions of each stream came back, against the direct runs, then the
   same clients again on the same engine (every tick shape the first run
   reached now run once), tick latency p50/p99 of both runs and the tick
   shapes warmup did not run; tick latency of both engines at buckets
   1, 4, 8 and 16 (information only). Each path runs with the launch
   counters set to 0 and must launch GeM and the depthwise conv.
7. The fold-fused ensemble, the sealed export and the parallel paths, at
   the flagship's full width on the inference phase's 414-frame video (bf16,
   TTA on), each with the launch counters set to 0: ``FusedFoldsPredictor``
   over 7 folds of seeded weights (BN calibrated) against each fold's
   single-fold engine (launches GeM 7×3, dwconv3d 7×12; wall time of the
   fused pass against 7 single-fold passes on the same host frames); the
   flagship chunked engine exported with ``torch.export`` on the card and
   reloaded in a fresh process that must not import the model code,
   against the live frame-carry engine (its launches counted there, ms per
   chunk exported and live), and a small checkpoint sealed on the CPU by
   the export CLI's own route, which must hold the depthwise op, run on the
   card against the CPU. The parallel paths take every visible card, or
   the one card twice: data-parallel predict on an N×1 grid against one
   device, fold-parallel on a 1×N grid (3 folds padded to 4 on one card, 7
   padded to 8 on four) against the fused engine, each timed and traced
   for each card's idle share; then 3 float32 flagship train steps
   (augmentation and mixup on) in N processes over NCCL (N the visible
   cards, 1 on one card) against the same steps in one process without a
   process group, the warp and GeM launched, and ms per bf16 step at 4
   rows per card against 4 rows on one card. On one card, equality across
   more than one rank is the CPU tests' (``tests/test_torch_parallel.py``).
8. Weights and model families, at the flagship's full width, each path
   with the launch counters set to 0: a seeded timm-layout
   ``tf_efficientnetv2_b0`` file (the ImageNet head and BN counts
   included) written as ``.safetensors`` (header and bytes written here)
   and as ``.pth``, each in its own ``BAS_TPU_PRETRAINED_DIR``; stage 1
   (``sampling_weights_001``) trains from the first and stage 2
   (``action_sampling_weights_002``) from the second, both as shipped
   (``pretrained=True``), cut in depth only as in phase 5: the encoder's
   weights and BN statistics at init bitwise the file's, the warp twice and
   GeM at least once per step, losses finite. A reference argus ``.pth`` of
   the inference phase's weights (EMA and raw, the reference's names)
   beside a lower-scored ``.ckpt`` of the same: discovery picks the
   ``.pth``, both load to the same state bitwise, the chunked engine
   predicts the 414-frame video from each (TTA on; GeM 3, dwconv3d 12
   launches) as the main path did, and the ``.pth`` is stage 3's stage
   pretrain (every tensor loaded). ``s2d_stem=True`` against the standard
   stem on that checkpoint (bf16 over the video, float32 over 46 frames).
   ``multichan_stacker`` (3 channels) over (2, 15, 3, 736, 1280), the
   depthwise kernel against the grouped conv; ``classifier2d`` with GeM
   over (4, 3, 736, 1280), one bf16 forward and backward, then the folded
   forward against the unfolded one in float32. GeM and the depthwise conv
   are timed at the multi-channel stacker's shapes.
9. Prints the ``kernels`` JSON line (one row per kernel and main path:
   GeM on the inference and on the training path, the depthwise conv, and
   the warp's H and V passes, each with its own launches and bound, and
   ``launches_by_path``: the recipe, serving, phase-7 and phase-8 paths of
   the same kind, each of which must launch it; then GeM and the depthwise
   conv at the serving and the multi-channel shapes, each with its paths),
   then the device line last.

Float32 comparisons run with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` set False): cuDNN would
otherwise run float32 convolutions in TF32.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from ball_action_spotting_torch.cli import (
    action_evaluate,
    action_predict,
    action_train,
    ball_ensemble,
    export_model,
)
from ball_action_spotting_torch.convert import flax_tree_to_state_dict, state_dict_to_flax_tree
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.core.postprocess import raw_predictions_to_actions
from ball_action_spotting_torch.core.sampling import ball_sampling_weights
from ball_action_spotting_torch.core.spotting import write_game_spotting_results
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data import (
    ClipLoader,
    TrainClipDataset,
    ValClipDataset,
    make_synthetic_video_data,
)
from ball_action_spotting_torch.data.gray_store import write_gray_store
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import action, ball
from ball_action_spotting_torch.eval.soccernet_map import evaluate_games
from ball_action_spotting_torch.eval.submission import make_submission_zip
from ball_action_spotting_torch.models import build_model, init_train_weights, init_weights
from ball_action_spotting_torch.models.effnetv2 import (
    EFFNETV2_ARCHS,
    BatchNormAct,
    BlockDef,
    EfficientNetV2Features,
)
from ball_action_spotting_torch.models.fold_bn import fold_bn_state_dict
from ball_action_spotting_torch.ops import KERNELS
from ball_action_spotting_torch.ops import dwconv3d as dw_ops
from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.ops import warp as warp_ops
from ball_action_spotting_torch.ops._cuda import build_all
from ball_action_spotting_torch.ops.augment import (
    AugmentConfig,
    apply_augment,
    sample_augment_params,
)
from ball_action_spotting_torch.ops.dwconv3d import (
    dwconv3d,
    dwconv3d_grouped_conv,
    dwconv3d_reference,
)
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_reference
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.ops.mixup import Mixup
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import make_mesh
from ball_action_spotting_torch.parallel.multihost import process_slice
from ball_action_spotting_torch.predict.__main__ import main as ball_predict
from ball_action_spotting_torch.predict.export import (
    ExportedChunkPredictor,
    export_chunked_predictor,
)
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.multistream import device_state_tick_ms, device_tick_ms
from ball_action_spotting_torch.predict.pipeline import predict_games
from ball_action_spotting_torch.predict.server import (
    _to_host,
    build_engine,
    make_server,
    warm_engine,
)
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    StreamingPredictor,
    get_raw_predictions,
    load_inference_variables,
)
from ball_action_spotting_torch.train.checkpoint import (
    get_best_checkpoint_path,
    load_checkpoint,
    resolve_pretrain_variables,
    save_checkpoint,
)
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.pipeline import resolve_stage_pretrain, train_stage
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step, normalize_frames
from ball_action_spotting_torch.utils.experiments import load_experiment_config
from ball_action_spotting_torch.utils.recipe import spotting_recipe

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores, which the kernels' arithmetic uses.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

CHUNK = 128
HEIGHT, WIDTH = 736, 1280
NN_KWARGS = dict(
    model_name="efficientnetv2_b0", num_classes=2, num_frames=15, stack_size=3,
    index_2d_features=4, num_3d_blocks=4, num_3d_features=192,
    expansion_3d_ratio=3, se_reduce_3d_ratio=24, num_3d_stack_proj=256,
    drop_rate=0.2, drop_path_rate=0.2, act_layer="silu",
)
PARAMS = {
    "nn_module": ("multidim_stacker", NN_KWARGS),
    "frame_stack_size": 15,
    "frame_stack_step": 2,
    "frames_processor": ("pad_normalize", {"size": (WIDTH, HEIGHT)}),
}
# Stated tolerances.
GEM_TOL = 1e-4         # × max|ref|: f32 sums in another order, MUFU log2/exp2 (~1e-6 rel.)
GEM_GRAD_RTOL = 1e-3   # × max|ref|: closed-form backward vs autograd of the plain version
GEM_GRAD_ROUND = 2.0 ** -8  # × |ref|: a bf16 input's dx leaves the backward rounded once to bf16
DW_TOL = 2.0 ** -7     # × max|ref|: one bf16 rounding step at the largest output
DW_F32_ATOL = 1e-5     # float32 sums of 27 taps of unit-scale inputs, other order
PRED_BF16_ATOL = 2e-2  # bf16 sigmoid outputs of two conv orders through 4 blocks
PRED_F32_ATOL = 1e-4   # float32 (TF32 off) chunked engine vs plain batch forward
WARP_BF16_TOL = 2.0 ** -7  # × max|ref|: one bf16 rounding step at the largest output
WARP_F32_ATOL = 1e-5   # float32 on [0, 1] images: two-tap sums in another order
STEP_LOSS_RTOL = 1e-4  # float32 train step, card (TF32 off) vs CPU
STEP_GRAD_TOL = 1e-3   # × max|ref| per gradient tensor, card vs CPU
STEP_GRAD_FLOOR = 1e-4  # × the largest gradient: the least max|ref| of a tensor

# Training phase: the flagship recipe at full width, 1 warmup + 1 train
# epoch of 16 samples at batch 4 (8 steps), and the warp's main-path shape
TRAIN_FRAMES = 15
BATCH = 4
TRAIN_EPOCH_SIZE = 16
WARP_N = BATCH * TRAIN_FRAMES  # frames per train step, each warped once
# The depthwise conv's edge shapes, (N, T, H, W, C), dtype, offset of x in
# elements: the ring over T at 1, 2 and 5 slices; a ragged (H 23) or whole
# (H 3) row tile; a warp with no columns (W 1) and a width near the staging
# limit (W 96); the narrow copy (C 6), a ragged channel tile (C 96) and the
# flagship's 9 tiles (C 576); the last case starts one pair past a 16-byte
# boundary, so x takes the narrow copy although C allows the wide one.
DW_EDGE_CASES = [
    ((2, 1, 23, 40, 576), torch.bfloat16, 0),
    ((1, 2, 3, 40, 96), torch.bfloat16, 0),
    ((2, 5, 23, 1, 96), torch.float16, 0),
    ((1, 5, 3, 96, 576), torch.bfloat16, 0),
    ((3, 5, 23, 40, 6), torch.bfloat16, 0),
    ((1, 2, 23, 40, 6), torch.float32, 0),
    ((2, 5, 3, 1, 6), torch.float16, 0),
    ((1, 1, 3, 96, 96), torch.float16, 0),
    ((1, 5, 23, 40, 96), torch.float32, 0),
    ((2, 2, 23, 96, 6), torch.bfloat16, 0),
    ((1, 5, 23, 40, 576), torch.float32, 0),
    ((1, 1, 3, 1, 576), torch.float32, 0),
    ((1, 2, 23, 40, 96), torch.bfloat16, 2),
]
# The shape route of ``ops/dwconv3d.py::dwconv3d`` on a CUDA tensor,
# (N, T, H, W, C), dtype, layout of x, kernel launches: odd C (one zero
# channel appended), more clips than a grid's y holds (the launcher slices
# N), a transposed (non-contiguous) and a pair-misaligned x (copied), and
# widths on both sides of the staging limit (bf16 W 201 stages, W 202 and
# float32 W 128 go to the grouped conv and launch nothing).
DW_ROUTE_CASES = [
    ((1, 3, 4, 6, 5), torch.bfloat16, "contiguous", 1),
    ((2, 2, 23, 40, 7), torch.float32, "contiguous", 1),
    ((65536, 1, 1, 1, 2), torch.bfloat16, "contiguous", 1),
    ((1, 2, 5, 6, 64), torch.bfloat16, "transposed", 1),
    ((1, 2, 5, 6, 9), torch.float16, "transposed", 1),
    ((1, 2, 5, 6, 64), torch.float16, "misaligned", 1),
    ((1, 2, 3, 201, 8), torch.bfloat16, "contiguous", 1),
    ((1, 2, 3, 202, 8), torch.bfloat16, "contiguous", 0),
    ((1, 2, 3, 128, 8), torch.float32, "contiguous", 0),
]
# GeM's edge shapes, (B, H, W, C), dtype, offset of x in elements: the
# 16-byte path (C 8, 256, 1280 in bf16/fp16; C 256, 1280 in float32) and the
# one-channel path (C 6; an x one element past a 16-byte boundary); H·W 1
# and 920; H·W split over several blocks (few batch rows) and not split
# (70000 batch rows in the kernel's one-dimensional grid).
GEM_EDGE_CASES = [
    ((3, 1, 1, 256), torch.bfloat16, 0),
    ((2, 23, 40, 6), torch.bfloat16, 0),
    ((3, 23, 40, 6), torch.float32, 0),
    ((2, 5, 4, 8), torch.float16, 0),
    ((1, 1, 1, 8), torch.float16, 0),
    ((2, 23, 40, 256), torch.bfloat16, 1),
    ((2, 23, 40, 256), torch.float32, 0),
    ((4, 23, 40, 1280), torch.float32, 0),
    ((1, 30, 31, 1280), torch.float16, 0),
    ((70000, 1, 2, 8), torch.bfloat16, 0),
]
# The warp's edge shapes: pass ("rows" = H, "columns" = V), (N, H, W),
# dtype, block, scale, base offset (the offsets are base + 0.01·t + 0.3·i
# for image i), precision, offset of the image in elements. W 100 (not a
# multiple of 8) and a misaligned view take the one-element path, as does
# block 7 in the V pass; scales 0.5, 2.0 and −1.0 (a flip about the last
# row or column); a base of 500 puts every tap outside (all zeros); fp16;
# a float32 image in bf16 mode; N 1 with H 1.
WARP_EDGE_CASES = [
    ("rows", (3, 37, 100), torch.bfloat16, 8, 0.97, 2.0, "bfloat16", 0),
    ("columns", (3, 37, 100), torch.bfloat16, 8, 0.97, 2.0, "bfloat16", 0),
    ("rows", (2, 40, 96), torch.bfloat16, 7, 1.03, -3.0, "bfloat16", 0),
    ("columns", (2, 40, 96), torch.bfloat16, 7, 1.03, -3.0, "bfloat16", 0),
    ("columns", (2, 40, 96), torch.float32, 8, 0.9, 1.0, "highest", 0),
    ("columns", (2, 40, 96), torch.float32, 8, 0.9, 1.0, "bfloat16", 0),
    ("rows", (2, 64, 128), torch.bfloat16, 32, 1.0, 0.5, "bfloat16", 1),
    ("columns", (2, 64, 128), torch.bfloat16, 32, 1.0, 0.5, "bfloat16", 1),
    ("rows", (2, 33, 128), torch.bfloat16, 32, 0.5, 30.0, "bfloat16", 0),
    ("columns", (2, 128, 64), torch.float32, 32, 2.0, -10.0, "highest", 0),
    ("rows", (2, 16, 256), torch.float16, 32, -1.0, 255.0, "highest", 0),
    ("columns", (2, 256, 16), torch.float16, 8, -1.0, 255.0, "highest", 0),
    ("rows", (2, 24, 64), torch.bfloat16, 8, 1.0, 500.0, "bfloat16", 0),
    ("columns", (1, 1, 64), torch.bfloat16, 32, 1.0, 0.0, "bfloat16", 0),
    ("rows", (1, 1, 64), torch.float32, 32, 1.0, 0.3, "highest", 0),
    ("rows", (3, 37, 1280), torch.float32, 32, 1.03, -3.0, "highest", 0),
]
# Recipe phase: one ball game (fold 0's) and one action game, two halves of
# 160 synthetic 1280x720 frames each (0.59 GB of gray stores). Ball events
# every 20 frames; one visible action per half (the val split is the train
# game: 2 val samples, one val step) beside "not shown" ones, which the
# visibility filter drops from training and the unshown split scores.
RECIPE_FRAMES = 160
VIDEO_HEIGHT = 720  # SoccerNet's 720p, padded to HEIGHT by the frames processor
BALL_EVENTS = {half: {f: (ball.classes[k % 2], None) for k, f in enumerate(range(20, 160, 20))}
               for half in (1, 2)}
ACTION_EVENTS = {1: {40: ("Goal", "visible"), 80: ("Corner", "not shown"),
                     120: ("Red card", "not shown")},
                 2: {60: ("Yellow card", "visible"), 100: ("Throw-in", "not shown")}}
MAP_ATOL = 0.02  # a_mAP@1 kernel vs default path, as PRED_BF16_ATOL for their sigmoids
# Serving phase: one synthetic 1280x720 video of 414 frames (3 chunks; the
# middle 720 rows of the inference phase's 736-row video), which the
# streaming engine runs (in float32 its first 160 frames), and 4 live
# streams of 96 frames, its first four 96-frame segments; a window spans 29
# frames (15 frames 2 apart), so each stream has 68 predictions. Tick
# latency at these buckets, against one frame at 25 fps.
SERVE_STREAMS = 4
SERVE_FRAMES = 96
SERVE_WINDOW = 29
STREAM_FRAMES = 3 * CHUNK + 30
STREAM_F32_FRAMES = 160
TICK_BUCKETS = (1, 4, 8, 16)
REALTIME_MS = 40.0
SERVE_MAX_BATCH = 2 * SERVE_STREAMS  # a backlogged tick takes 2 frames per stream
# GeM at the host-state engine's (bucket 8 · TTA 2, 23, 40, 5·256) and the
# device-state tick's (bucket 8 · TTA 2 · 5 stacks, 23, 40, 256) head, the
# depthwise conv at N = bucket 8 · TTA 2
SERVE_GEM_SHAPES = {"gem_pool_serve_host": (16, 23, 40, 5 * 256),
                    "gem_pool_serve_device": (80, 23, 40, 256)}
SERVE_DW_N = 16
TINY_ARCH = (8, (BlockDef("cn", 1, 3, 1, 1, 8), BlockDef("er", 1, 3, 2, 2, 8),
                 BlockDef("er", 1, 3, 2, 2, 16), BlockDef("ir", 1, 3, 2, 2, 16, 0.25),
                 BlockDef("ir", 1, 3, 2, 2, 24, 0.25)), 1.0, 1.0)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, match: str, reps: int = 10, warmup: int = 2, per_call: int = 1,
              tries: int = 3) -> float:
    """The kernel's own time per call: the median over ``reps`` calls of
    ``fn`` of the summed device time of the ``per_call`` kernels a call
    launches whose name holds ``match`` (torch.profiler, which traces
    ctypes launches like any other). A window in which the profiler saw
    another count than ``per_call · reps`` launches is profiled again, up
    to ``tries`` times, and then fails the run."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name)
        seen.append(len(spans))
        if len(spans) == per_call * reps:
            return statistics.median(
                sum(end - start for start, end in spans[i:i + per_call]) / 1e3
                for i in range(0, len(spans), per_call))
    fail(f"the profiler saw {seen} launches of {match!r} in windows of {reps} calls, "
         f"expected {per_call * reps}")


def device_ms_per_kernel(fn, match: str, kernels: int, reps: int = 10, warmup: int = 2,
                         tries: int = 3) -> float:
    """``device_ms`` for the serving shapes' rows, where the tracer missed
    kernels of a window on the card (7 of 24 at GeM's two launches at
    (80, 23, 40, 256)): the sum over the ``kernels`` kernels whose name
    holds ``match`` of each one's median device time over the launches the
    profiler saw of its last ``reps``, at least ``reps // 2``. The window
    runs ``warmup + reps`` calls and is profiled again, up to ``tries``
    times, while it sees fewer."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(warmup + reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in sorted(prof.events(), key=lambda e: e.time_range.start):
            if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name:
                by_name.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
        seen.append({name[:40]: len(v) for name, v in by_name.items()})
        if len(by_name) == kernels and all(len(v) >= reps // 2 for v in by_name.values()):
            return sum(statistics.median(v[-reps:]) for v in by_name.values())
    fail(f"the profiler saw {seen} launches of {match!r} in windows of {warmup + reps} calls")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1 ---

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
         "kernels": [k.name for k in KERNELS]})
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "spill" in line):
                log(f"  [{name}] {line.strip()}")


# --------------------------------------------------------------- phase 2 ---

def gem_backward_diffs(x, p) -> dict:
    """The kernel forward + closed-form backward against autograd of the
    plain version on ``x``'s values in float32: max|diff| of dx and dp, and
    whether each is within its tolerance. A bf16 ``x`` gets a bf16 dx, as
    the train step does, so each element may also differ by its one
    rounding to bf16."""
    xk, pk = x.detach().clone().requires_grad_(True), p.clone().requires_grad_(True)
    (gem_pool(xk, pk) ** 2).sum().backward()
    xr, pr = x.detach().float().requires_grad_(True), p.clone().requires_grad_(True)
    (gem_pool_reference(xr, pr) ** 2).sum().backward()
    rounding = GEM_GRAD_ROUND if x.dtype == torch.bfloat16 else 0.0
    dx, dx_ref = xk.grad.float(), xr.grad
    dx_diff = (dx - dx_ref).abs()
    dx_ok = bool((dx_diff <= GEM_GRAD_RTOL * dx_ref.abs().max()
                  + rounding * dx_ref.abs()).all())
    dp_diff = (pk.grad - pr.grad).abs().item()
    dp_ok = dp_diff <= GEM_GRAD_RTOL * pr.grad.abs().item()
    if not (dx_ok and dp_ok):
        fail(f"gem backward ({x.dtype}, {tuple(x.shape)}) disagrees with autograd of the "
             f"plain version: dx max|diff| {dx_diff.max().item()}, dp |diff| {dp_diff}")
    return {"dx_max_abs_diff": dx_diff.max().item(), "dx_ref_max": dx_ref.abs().max().item(),
            "dp_abs_diff": dp_diff, "dp_ref": pr.grad.item()}


def check_gem(dev, shape: tuple, path: str, per_kernel: bool = False) -> dict:
    """GeM at one of its main-path shapes in bf16: the inference head's
    (num_tta·CHUNK·5, 23, 40, 256) or the train step's head
    (BATCH, 23, 40, 5·256). The backward is checked on the first CHUNK·5
    rows in float32 and in bf16 (the train step's dtype). ``per_kernel``
    takes the device time by ``device_ms_per_kernel``."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    p = torch.tensor([3.0], device=dev)
    out = gem_pool(x, p)
    ref = gem_pool_reference(x, p)
    err = (out - ref).abs().max().item()
    tol = GEM_TOL * ref.abs().max().item()
    if not err <= tol:
        fail(f"gem kernel vs plain ({path}, {shape}): max|diff| {err} > {tol}")
    if not torch.equal(gem_pool(x, p), out):
        fail(f"gem kernel ({path}, {shape}): two runs on one input differ")
    backward = {"float32": gem_backward_diffs(x[: CHUNK * 5].float(), p),
                "bfloat16": gem_backward_diffs(x[: CHUNK * 5], p)}
    torch.cuda.empty_cache()

    nbytes = x.numel() * 2 + out.numel() * 4 + 4
    bound_ms, bound_by = bound(nbytes, 5 * x.numel())  # clamp, log, mul, exp, add
    b, h, w, c = shape  # bf16, contiguous: 8 channels a lane; split H·W is two launches
    splits = gem_ops.gem_splits(b, h * w, c, 8, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
    launches = 2 if splits > 1 else 1
    row = {
        "name": "gem_pool", "path": path, "shape": list(x.shape), "dtype": "bfloat16",
        "max_abs_diff": err, "tolerance": tol,
        "kernel_ms": median_ms(lambda: gem_pool(x, p)),
        "direct_ms": median_ms(lambda: gem_ops.gem_pool_cuda(x, p)),
        "device_ms": (device_ms_per_kernel(lambda: gem_pool(x, p), "gem_", launches)
                      if per_kernel else device_ms(lambda: gem_pool(x, p), "gem_",
                                                   per_call=launches)),
        "device_ms_method": "per_kernel_median" if per_kernel else "per_call_sum",
        "plain_ms": median_ms(lambda: gem_pool_reference(x, p)),
        "library_ms": median_ms(
            lambda: x.float().clamp_min(1e-6).pow(p).mean((1, 2)).pow(1.0 / p)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "backward": backward, "grad_rtol": GEM_GRAD_RTOL, "bf16_dx_rounding": GEM_GRAD_ROUND,
        "gem_splits": splits,
    }
    log(row)
    return row


def check_dwconv(dev, num_tta: int, n: int | None = None, path: str = "inference",
                 per_kernel: bool = False) -> dict:
    """The depthwise conv at (n, 5, 23, 40, 576) bf16, n = num_tta·CHUNK
    (the chunk program's) unless given. ``per_kernel`` takes the device
    time by ``device_ms_per_kernel``."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n or num_tta * CHUNK, 5, 23, 40, 576), generator=g,
                    device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, 1, 576), generator=g, device=dev) / 27 ** 0.5).to(torch.bfloat16)
    out = dwconv3d(x, k)
    ref = dwconv3d_reference(x, k)
    err = (out.float() - ref.float()).abs().max().item()
    tol = DW_TOL * ref.float().abs().max().item()
    if not err <= tol:
        fail(f"dwconv3d kernel vs plain: max|diff| {err} > {tol}")
    lib_err = (dwconv3d_grouped_conv(x, k).float() - ref.float()).abs().max().item()
    del ref, out
    torch.cuda.empty_cache()

    nbytes = 2 * x.numel() * 2 + 27 * 576 * 2
    bound_ms, bound_by = bound(nbytes, 54 * x.numel())
    row = {
        "name": "dwconv3d", "path": path, "tta": num_tta == 2, "shape": list(x.shape),
        "dtype": "bfloat16",
        "max_abs_diff": err, "tolerance": tol, "library_max_abs_diff": lib_err,
        "kernel_ms": median_ms(lambda: dwconv3d(x, k)),
        "direct_ms": median_ms(lambda: dw_ops._dwconv3d_cuda_route(x, k)),
        "device_ms": (device_ms_per_kernel(lambda: dwconv3d(x, k), "dwconv3d_kernel", 1)
                      if per_kernel else device_ms(lambda: dwconv3d(x, k), "dwconv3d_kernel")),
        "device_ms_method": "per_kernel_median" if per_kernel else "per_call_sum",
        "plain_ms": median_ms(lambda: dwconv3d_reference(x, k)),
        "library_ms": median_ms(lambda: dwconv3d_grouped_conv(x, k)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(row)
    return row


def check_dwconv_edges(dev) -> None:
    """The depthwise kernel against its plain version at ``DW_EDGE_CASES``."""
    g = torch.Generator(device=dev).manual_seed(4)
    t0 = time.perf_counter()
    worst = 0.0
    for shape, dtype, offset in DW_EDGE_CASES:
        flat = torch.randn(math.prod(shape) + offset, generator=g, device=dev).to(dtype)
        x = flat[offset:].view(shape)
        k = torch.randn((3, 3, 3, 1, shape[-1]), generator=g, device=dev) / 27 ** 0.5
        ref = dwconv3d_reference(x, k).float()
        err = (dwconv3d(x, k).float() - ref).abs().max().item()
        tol = DW_F32_ATOL if dtype == torch.float32 else DW_TOL * ref.abs().max().item()
        if not err <= tol:
            fail(f"dwconv3d kernel vs plain at {shape} {dtype} offset {offset}: "
                 f"max|diff| {err} > {tol}")
        worst = max(worst, err / tol)
    for shape, dtype, layout, launches in DW_ROUTE_CASES:
        x = route_input(shape, dtype, layout, lambda numel: torch.randn(
            numel, generator=g, device=dev))
        k = torch.randn((3, 3, 3, 1, shape[-1]), generator=g, device=dev) / 27 ** 0.5
        ref = dwconv3d_reference(x, k).float()
        before = dw_ops.KERNEL.launches
        out = dwconv3d(x, k)
        made = dw_ops.KERNEL.launches - before
        err = (out.float() - ref).abs().max().item()
        tol = DW_F32_ATOL if dtype == torch.float32 else DW_TOL * ref.abs().max().item()
        if not (err <= tol and made == launches and out.shape == x.shape
                and out.dtype == dtype):
            fail(f"dwconv3d route at {shape} {dtype} {layout}: max|diff| {err} (tolerance "
                 f"{tol}), {made} kernel launches (expected {launches}), "
                 f"out {tuple(out.shape)} {out.dtype}")
        worst = max(worst, err / tol)
    torch.cuda.synchronize()
    log({"check": "dwconv3d_edge_shapes", "cases": len(DW_EDGE_CASES) + len(DW_ROUTE_CASES),
         "worst_diff_over_tolerance": worst, "seconds": time.perf_counter() - t0})


def route_input(shape: tuple, dtype, layout: str, randn) -> torch.Tensor:
    """An x of ``shape`` for ``DW_ROUTE_CASES``: contiguous, the transpose
    of a contiguous tensor in H and W, or a contiguous view one element
    past an allocation's start (off a channel pair). ``randn(numel)`` gives
    the float32 values."""
    if layout == "transposed":
        n, t, h, w, c = shape
        return randn(math.prod(shape)).to(dtype).view(n, t, w, h, c).transpose(2, 3)
    offset = 1 if layout == "misaligned" else 0
    return randn(math.prod(shape) + offset).to(dtype)[offset:].view(shape)


def check_gem_edges(dev) -> None:
    """GeM's kernel against its plain version at ``GEM_EDGE_CASES``, each
    run twice for bit-identical output."""
    g = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    worst = 0.0
    p = torch.tensor([3.0], device=dev)
    for shape, dtype, offset in GEM_EDGE_CASES:
        flat = torch.randn(math.prod(shape) + offset, generator=g, device=dev).to(dtype)
        x = flat[offset:].view(shape)
        before = gem_ops.KERNEL.launches
        out = gem_pool(x, p)
        ref = gem_pool_reference(x, p)
        err = (out - ref).abs().max().item()
        tol = GEM_TOL * ref.abs().max().item()
        if not (err <= tol and gem_ops.KERNEL.launches == before + 1
                and torch.equal(gem_pool(x, p), out)):
            fail(f"gem kernel vs plain at {shape} {dtype} offset {offset}: max|diff| {err} "
                 f"(tolerance {tol}), or not launched once, or two runs differ")
        worst = max(worst, err / tol)
    torch.cuda.synchronize()
    log({"check": "gem_edge_shapes", "cases": len(GEM_EDGE_CASES),
         "worst_diff_over_tolerance": worst, "seconds": time.perf_counter() - t0})


def warp_edge_inputs(case, values):
    """(img, kernel call, plain call) of one ``WARP_EDGE_CASES`` case;
    ``values(numel)`` gives the image's float32 values on the device."""
    axis, (n, h, w), dtype, block, scale, base, precision, offset = case
    img = values(n * h * w + offset).to(dtype)[offset:].view(n, h, w)
    dev = img.device
    length = h if axis == "rows" else w
    scales = torch.full((n,), scale, device=dev)
    offsets = (base + 0.01 * torch.arange(length, device=dev)[None]
               + 0.3 * torch.arange(n, device=dev)[:, None]).float()
    if axis == "rows":
        def kernel():
            return warp_ops.resample_last_axis(img, scales, offsets, block, precision)

        def plain():
            return warp_ops.resample_last_axis_reference(img, scales, offsets, block, precision)
    else:
        def kernel():
            return warp_ops.resample_columns(img, scales, offsets, block, precision)

        def plain():
            return warp_ops.resample_last_axis_reference(
                img.transpose(1, 2), scales, offsets, block, precision).transpose(1, 2)
    return img, kernel, plain


def warp_tolerance(dtype, precision: str, ref: torch.Tensor) -> float:
    """float32 out of float32 math: atol 1e-5; anything rounded to bf16 or
    fp16: one bf16 step at the largest output."""
    if dtype == torch.float32 and precision == "highest":
        return WARP_F32_ATOL
    return WARP_BF16_TOL * ref.float().abs().max().item()


def check_warp_edges(dev) -> None:
    """The warp kernel against its plain version at ``WARP_EDGE_CASES``."""
    g = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    worst = 0.0
    for case in WARP_EDGE_CASES:
        img, kernel, plain = warp_edge_inputs(
            case, lambda numel: torch.rand(numel, generator=g, device=dev))
        before = warp_ops.KERNEL.launches
        out, ref = kernel(), plain()
        err = (out.float() - ref.float()).abs().max().item()
        tol = warp_tolerance(img.dtype, case[6], ref)
        if not (err <= tol and out.dtype == img.dtype
                and warp_ops.KERNEL.launches == before + 1):
            fail(f"warp kernel vs plain at {case}: max|diff| {err} > {tol}, or out "
                 f"{out.dtype}, or not launched once")
        if case[5] >= 500.0 and out.abs().max().item() != 0.0:
            fail(f"warp kernel at {case}: taps all outside, output not zero")
        worst = max(worst, err / tol if tol else err)
    torch.cuda.synchronize()
    log({"check": "warp_edge_shapes", "cases": len(WARP_EDGE_CASES),
         "worst_diff_over_tolerance": worst, "seconds": time.perf_counter() - t0})


def interpolation_matrices(scale, off_c, w: int, dtype) -> torch.Tensor:
    """(N·nb, W, W) bilinear interpolation matrices of a resample pass, the
    operands of the library call (``torch.bmm`` of the row blocks)."""
    n, nb = off_c.shape
    out = torch.empty((n * nb, w, w), dtype=dtype, device=off_c.device)
    for i in range(n):
        out[i * nb:(i + 1) * nb] = warp_ops.interpolation_matrices(scale[i], off_c[i], w)
    return out


def check_warp(dev, axis: str, dtype) -> dict:
    """The warp kernel against its plain version at the train step's H-pass
    (60, 736, 1280) or V-pass (60, 1280, 736) shape, with shear."""
    g = torch.Generator(device=dev).manual_seed(3)
    n, h, w = WARP_N, HEIGHT, WIDTH
    img = torch.rand((n, h, w), generator=g, device=dev).to(dtype)
    length = h if axis == "rows" else w
    scale = 0.9 + 0.2 * torch.rand(n, generator=g, device=dev)
    shear = 0.1 * torch.rand(n, generator=g, device=dev) - 0.05
    shift = 60.0 * torch.rand(n, generator=g, device=dev) - 30.0
    offsets = shear[:, None] * torch.arange(length, device=dev)[None] + shift[:, None]
    precision = "bfloat16" if dtype == torch.bfloat16 else "highest"
    pass_axis = 2 if axis == "rows" else 1

    def direct():
        return warp_ops._resample_cuda(img, scale, offsets, 32, precision, pass_axis)

    if axis == "rows":
        def kernel():
            return warp_ops.resample_last_axis(img, scale, offsets, 32, precision)

        def plain():
            return warp_ops.resample_last_axis_reference(img, scale, offsets, 32, precision)
        blocks_of = img
    else:
        def kernel():
            return warp_ops.resample_columns(img, scale, offsets, 32, precision)

        def plain():
            return warp_ops.resample_last_axis_reference(
                img.transpose(1, 2), scale, offsets, 32, precision).transpose(1, 2)
        blocks_of = img.transpose(1, 2).contiguous()  # the library multiplies rows
    out, ref = kernel(), plain()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (WARP_BF16_TOL * ref.float().abs().max().item() if dtype == torch.bfloat16
           else WARP_F32_ATOL)
    if not err <= tol:
        fail(f"warp kernel ({axis}, {dtype}) vs plain: max|diff| {err} > {tol}")
    del out, ref
    row = {"name": "warp_resample", "pass": "H" if axis == "rows" else "V",
           "shape": [n, h, w], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_diff": err, "tolerance": tol,
           "kernel_ms": median_ms(kernel), "direct_ms": median_ms(direct),
           "device_ms": device_ms(kernel, "resample"),
           "plain_ms": median_ms(plain, reps=3, warmup=1)}
    # the library call: one bmm of the row blocks with the interpolation
    # matrices, built before the clock starts
    off_c = warp_ops.block_center_offsets(offsets, 32)
    mats = interpolation_matrices(scale, off_c, w if axis == "rows" else h, dtype)
    rows, width = blocks_of.shape[1], blocks_of.shape[2]
    nb = off_c.shape[1]
    padded = torch.zeros((n, nb * 32, width), dtype=dtype, device=dev)
    padded[:, :rows] = blocks_of
    lhs = padded.reshape(n * nb, 32, width)
    row["library_ms"] = median_ms(lambda: torch.bmm(lhs, mats))
    del mats, lhs, padded
    torch.cuda.empty_cache()
    elt = img.element_size()
    row["bound_ms"], row["bound_by"] = bound(2 * img.numel() * elt + 4 * n * (nb + 1),
                                             6 * img.numel())
    log(row)
    return row


# --------------------------------------------------------------- phase 3 ---

def calibrate_bn(model, x) -> None:
    """Set every BN's running statistics to those of its input on ``x``, so
    that the seeded random network keeps activations normalized and its
    outputs depend on the frames."""
    def hook(mod, args):
        (inp,) = args
        dims = (tuple(range(inp.dim() - 1)) if mod.channels_last
                else (0,) + tuple(range(2, inp.dim())))
        mod.running_mean.copy_(inp.float().mean(dims))
        mod.running_var.copy_(inp.float().var(dims))

    hooks = [m.register_forward_pre_hook(hook)
             for m in model.modules() if isinstance(m, BatchNormAct)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()


def flagship_weights(dev, frames: np.ndarray, seed: int = 0) -> dict:
    model = build_model("multidim_stacker", **NN_KWARGS)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(dev).eval()
    n = NN_KWARGS["num_frames"]
    clip = torch.from_numpy(frames[0:2 * n:2][None]).to(dev).float() / 255.0
    calibrate_bn(model, clip)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def run_video(predictor, frames: np.ndarray):
    """(frame_indexes, raw, seconds) over the whole synthetic video."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, raw = predictor.predict_video(iter(enumerate(frames)), len(frames))
    return idx, raw, time.perf_counter() - t0


def staged_chunk(predictor, frames: np.ndarray):
    """(new frames on the card, carry) after one warm-up chunk program."""
    new = torch.from_numpy(frames[:CHUNK]).to(predictor.device)
    carry = predictor.init_carry(frames[:predictor.overlap])
    _, carry = predictor.chunk_features(new, carry)
    torch.cuda.synchronize()
    return new, carry


def device_fps(predictor, frames: np.ndarray, chunks: int = 6) -> float:
    """Chunk programs on frames already on the card: chunk frames per second."""
    with torch.inference_mode():
        new, carry = staged_chunk(predictor, frames)
        t0 = time.perf_counter()
        for _ in range(chunks):
            preds, carry = predictor.chunk_features(new, carry)
        torch.cuda.synchronize()
    return chunks * CHUNK / (time.perf_counter() - t0)


def union_us(intervals: list) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def device_time(prof, reps: int, width: int, top: int) -> tuple[float, float, list]:
    """(busy ms, summed kernel ms, top kernels) per repetition of a profiled
    run. Busy time is the union of the device activities' intervals: cuDNN
    may run kernels on several streams at once, so their sum can exceed the
    wall time."""
    busy_us = union_us([(e.time_range.start, e.time_range.end) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA])
    kernels = [e for e in prof.key_averages()  # device-side activities only
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if busy_us <= 0 or not kernels:
        fail("the profiler saw no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    summed_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return busy_us / 1e3 / reps, summed_ms, [
        [e.key[:width], e.self_device_time_total / 1e3 / reps, e.count // reps]
        for e in kernels[:top]]


def profile_chunks(predictor, frames: np.ndarray, chunks: int = 3) -> dict:
    """Device time by kernel over a few chunk programs on frames already on
    the card (torch.profiler), the busy and idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        new, carry = staged_chunk(predictor, frames)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(chunks):
                preds, carry = predictor.chunk_features(new, carry)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / chunks
    busy_ms, summed_ms, top = device_time(prof, chunks, 240, 12)
    row = {
        "phase": "profile", "tta": predictor.tta, "chunks": chunks,
        "wall_ms_per_chunk": wall_ms, "device_busy_ms_per_chunk": busy_ms,
        "kernel_sum_ms_per_chunk": summed_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "top": top,
    }
    log(row)
    return row


def check_outputs(name: str, idx, raw, expected_len: int) -> None:
    if len(idx) != expected_len or raw.shape != (expected_len, 2):
        fail(f"{name}: got {len(idx)} indexes and shape {raw.shape}")
    if not (np.isfinite(raw).all() and raw.min() >= 0.0 and raw.max() <= 1.0):
        fail(f"{name}: predictions not finite in [0, 1]")


def agree(name: str, a: np.ndarray, b: np.ndarray, atol: float) -> float:
    diff = float(np.abs(a - b).max())
    log({"check": name, "max_abs_diff": diff, "atol": atol})
    if not diff <= atol:
        fail(f"{name}: max|diff| {diff} > {atol}")
    return diff


def flagship(dev, card: str) -> tuple[dict, tuple, np.ndarray, np.ndarray]:
    """The chunked inference phase; returns its launches, the seeded
    weights and synthetic video, which the serving and ensemble phases use
    again, and the main path's predictions."""
    num_frames = 3 * CHUNK + 30  # 3 chunks of predictions
    src = SyntheticSource(num_frames=num_frames, height=HEIGHT, width=WIDTH, seed=0,
                          events={100: 0, 200: 1, 300: 0})
    frames = np.stack([src.fetch_frame(i) for i in range(num_frames)])
    expected = num_frames - 30
    weights = (flagship_weights(dev, frames), PARAMS)

    def predictor(**kw):
        return ChunkedVideoPredictor(weights=weights, device=dev, chunk_size=CHUNK, **kw)

    main = predictor(tta=True, dw3d_use_kernel=True)
    run_video(main, frames[: CHUNK + 30])  # warm-up: cuDNN plans, kernel loads
    for k in KERNELS:
        k.reset_counts()
    idx, raw_main, secs_main = run_video(main, frames)
    launches = {k.name: k.launches for k in KERNELS}
    log({"phase": "main_path", "tta": True, "dw3d_use_kernel": True,
         "launches": launches, "seconds": secs_main})
    if not (launches["gem"] > 0 and launches["dwconv3d"] > 0):
        fail(f"the inference main path did not launch GeM and dwconv3d: {launches}")
    check_outputs("main path", idx, raw_main, expected)

    with tempfile.TemporaryDirectory() as tmp:
        actions = raw_predictions_to_actions(idx, raw_main, ball.DOMAIN, verbose=False)
        path = write_game_spotting_results({1: actions}, "synthetic", Path(tmp), ball.DOMAIN)
        spotting = json.loads(path.read_text())
        if spotting["UrlLocal"] != "synthetic" or not isinstance(spotting["predictions"], list):
            fail("spotting JSON malformed")
    log({"check": "spotting_json", "predictions": len(spotting["predictions"])})

    _, raw_tta_lib, _ = run_video(predictor(tta=True, dw3d_use_kernel=False), frames)
    agree("tta_kernel_vs_default", raw_main, raw_tta_lib, PRED_BF16_ATOL)
    _, raw_k, secs_k = run_video(predictor(dw3d_use_kernel=True), frames)
    _, raw_d, _ = run_video(predictor(dw3d_use_kernel=False), frames)
    agree("kernel_vs_default", raw_k, raw_d, PRED_BF16_ATOL)
    frame_carry = predictor(dw3d_use_kernel=True, carry_features=False)
    idx_f, raw_f, _ = run_video(frame_carry, frames)
    check_outputs("frame carry", idx_f, raw_f, expected)
    agree("feature_vs_frame_carry", raw_k, raw_f, PRED_BF16_ATOL)
    spread = float(raw_k.std(axis=0).max())
    log({"check": "prediction_spread_over_frames", "std": spread})

    # float32 with TF32 off: the chunked engine against the plain batch
    # forward of each prediction window (the repo's cache-correctness check)
    f32 = ChunkedVideoPredictor(weights=weights, device=dev, chunk_size=8,
                                dtype=torch.float32, dw3d_use_kernel=True)
    short = frames[:46]
    idx32, raw32, _ = run_video(f32, short)
    gen = f32.indexes_generator
    with torch.inference_mode():
        clips = torch.stack([torch.from_numpy(short[gen.make_stack_indexes(i)])
                             for i in idx32]).to(dev).float() / 255.0
        direct = torch.sigmoid(f32.model(clips).float()).cpu().numpy()
    agree("f32_chunked_vs_batch_forward", raw32, direct, PRED_F32_ATOL)

    fps = {
        "card": card,
        "end_to_end_fps_tta_on": expected / secs_main,
        "end_to_end_fps_tta_off": expected / secs_k,
        "device_fps_tta_off": device_fps(predictor(dw3d_use_kernel=True), frames),
        "device_fps_tta_on": device_fps(main, frames),
        "device_fps_tta_off_default_dwconv": device_fps(predictor(dw3d_use_kernel=False),
                                                        frames),
    }
    log({"phase": "fps", **fps})
    profile_chunks(predictor(dw3d_use_kernel=True), frames)
    profile_chunks(main, frames)
    return launches, weights, frames, raw_main


# --------------------------------------------------------------- phase 4 ---

def flagship_config(epoch_size: int = TRAIN_EPOCH_SIZE) -> dict:
    return spotting_recipe(num_classes=2, image_size=(WIDTH, HEIGHT), batch_size=BATCH,
                           train_epoch_size=epoch_size, num_epochs=(1, 1), pretrained=False,
                           num_decode_workers=4)


def flagship_loaders(config: dict, ordered: bool = False):
    ap = config["argus_params"]
    gen = StackIndexesGenerator(ap["frame_stack_size"], ap["frame_stack_step"])
    tproc = MaxWindowTargetsProcessor(config["max_targets_window_size"])
    train_videos = make_synthetic_video_data(2, 400, ball.classes, height=HEIGHT, width=WIDTH)
    val_videos = make_synthetic_video_data(1, 130, ball.classes, height=HEIGHT, width=WIDTH)
    sw = config["train_sampling_weights"]
    weights = [ball_sampling_weights(v, sw["action_window_size"], sw["action_prob"],
                                     sw["clear_pred_window_size"]) for v in train_videos]
    train_ds = TrainClipDataset(train_videos, ball.classes, gen, tproc,
                                image_size=(WIDTH, HEIGHT), epoch_size=config["train_epoch_size"],
                                videos_sampling_weights=weights, base_seed=0)
    val_ds = ValClipDataset(val_videos, ball.classes, gen, tproc, image_size=(WIDTH, HEIGHT))
    workers = config["num_decode_workers"]
    return (ClipLoader(train_ds, BATCH, num_workers=workers, ordered=ordered),
            ClipLoader(val_ds, BATCH, num_workers=workers))


def train_main_path(dev, tmp: Path) -> dict:
    """The port's Trainer on the flagship recipe: the training main path."""
    config = flagship_config()
    trainer = Trainer(config, list(ball.classes), tmp, augment=AugmentConfig(), device=dev)
    train_loader, val_loader = flagship_loaders(config)
    losses, gem_per_step = [], []
    step = trainer.train_step
    gem_kernel = next(k for k in KERNELS if k.name == "gem")

    def recording_step(state, frames, targets, seed):
        before = gem_kernel.launches
        aux = step(state, frames, targets, seed)
        losses.append(aux["loss"])
        gem_per_step.append(gem_kernel.launches - before)
        return aux

    trainer.train_step = recording_step
    for k in KERNELS:
        k.reset_counts()
    t0 = time.perf_counter()
    best = trainer.fit(train_loader, val_loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    warp_passes = dict(warp_ops.KERNEL.launches_by)
    losses = [float(x) for x in losses]
    state = trainer.state
    ema_gap = max((a - b).abs().max().item() for a, b in
                  zip(state.ema.parameters(), state.model.parameters()))
    log({"phase": "train_main_path", "steps": state.step, "losses": losses,
         "launches": launches, "warp_launches_by_pass": warp_passes,
         "gem_launches_per_step": gem_per_step,
         "ema_vs_raw_max_abs": ema_gap, "seconds": seconds,
         "train_samples_per_sec_with_loading": best.get("train_samples_per_sec"),
         "val_average_precision": best.get("val_average_precision")})
    expected_steps = 2 * -(-TRAIN_EPOCH_SIZE // BATCH)
    if state.step != expected_steps or len(losses) != expected_steps:
        fail(f"train main path took {state.step} steps, expected {expected_steps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"a train loss is not finite: {losses}")
    if not ema_gap > 0.0:
        fail("the EMA equals the raw weights after training")
    if launches["warp"] != 2 * expected_steps or warp_passes != {"H": expected_steps,
                                                                 "V": expected_steps}:
        fail(f"warp kernel launched {launches['warp']} times ({warp_passes}), "
             "expected an H pass and a V pass per step")
    if not all(n >= 1 for n in gem_per_step):
        fail(f"gem_pool did not launch on every train step: {gem_per_step}")

    ckpt = get_best_checkpoint_path(tmp)
    if ckpt is None:
        fail("training wrote no best checkpoint")
    src = SyntheticSource(num_frames=60, height=HEIGHT, width=WIDTH, seed=1)
    frames = np.stack([src.fetch_frame(i) for i in range(60)])
    predictor = ChunkedVideoPredictor(ckpt, device=dev, chunk_size=16)
    idx, raw, _ = run_video(predictor, frames)
    check_outputs("predictor from the trained checkpoint", idx, raw, 30)
    log({"check": "predict_from_trained_checkpoint", "checkpoint": ckpt.name,
         "predictions": len(idx)})
    return {"launches": {**launches, "warp_H": warp_passes["H"], "warp_V": warp_passes["V"]},
            "trainer": trainer, "losses": losses, "checkpoint": ckpt}


def learning_check(dev) -> None:
    """10 steps on one fixed batch, training mode (batch-statistic BN), no
    augmentation: the loss must drop. Drop rates are 0 and the rate a
    constant 1e-4, so the per-step loss follows the fit and not the masks;
    at 1e-3 a single AdamW step moved the 1280 classifier inputs' logits by
    about 1 and the loss jumped (0.23 → 1.38 on the card)."""
    config = flagship_config()
    name, kwargs = config["argus_params"]["nn_module"]
    model = build_model(name, dtype=torch.bfloat16,
                        **{**kwargs, "drop_rate": 0.0, "drop_path_rate": 0.0})
    init_train_weights(model, torch.Generator().manual_seed(1))
    model.to(dev)
    state = TrainState(model, build_optimizer("AdamW", {}, model))
    step = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda count: 1e-4, 0.999)
    loader, _ = flagship_loaders(config, ordered=True)
    frames, targets = next(iter(loader.epoch(0)))
    frames, targets = torch.from_numpy(np.array(frames)).to(dev), torch.from_numpy(
        np.array(targets)).to(dev)
    losses = [float(step(state, frames, targets, 0)["loss"]) for _ in range(10)]
    log({"check": "fixed_batch_learning", "losses": losses})
    if not (statistics.mean(losses[-3:]) < losses[0]
            and all(math.isfinite(x) for x in losses)):
        fail(f"the loss did not drop on a fixed batch: {losses}")


def f32_step_card_vs_cpu(dev) -> None:
    """One float32 train step (tiny arch, 64x96, drop rates 0, the same
    sampled augmentation) on the card and on the CPU."""
    EFFNETV2_ARCHS["efficientnetv2_test"] = TINY_ARCH
    kwargs = dict(model_name="efficientnetv2_test", num_classes=2, num_frames=6, stack_size=3,
                  index_2d_features=4, num_3d_blocks=2, num_3d_features=16,
                  num_3d_stack_proj=16, expansion_3d_ratio=2, se_reduce_3d_ratio=4)
    cfg = AugmentConfig(warp_precision="highest", camera_move_p=1.0, rotation_p=1.0,
                        sharpness_p=0.5, motion_blur_p=0.5, posterize_p=0.5, noise_p=0.5)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (4, 6, 64, 96), dtype=np.uint8))
    targets = torch.from_numpy((rng.random((4, 2)) > 0.5).astype(np.float32))
    g = torch.Generator().manual_seed(2)
    params = sample_augment_params(g, g, 4, 6, 64, 96, cfg)
    loss_fn = FocalLoss(alpha=-1.0, gamma=1.2)
    results = {}
    for device in ("cpu", dev):
        model = build_model("multidim_stacker", **kwargs)
        init_train_weights(model, torch.Generator().manual_seed(3))
        model.to(device).train()
        x = apply_augment(normalize_frames(frames.to(device)),
                          {k: v.to(device) for k, v in params.items()}, cfg)
        loss = loss_fn(model(x), targets.to(device))
        loss.backward()
        results[str(device)] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()})
    (cpu_loss, cpu_grads), (card_loss, card_grads) = results["cpu"], results[str(dev)]
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    # A BN bias whose output reaches the next batch-statistic BN only through
    # a conv has a gradient of exactly 0 (that BN subtracts the batch mean);
    # what is left of it is float32 rounding noise, ~1e-8, which no share of
    # its own max can hold. Such a tensor's max is floored at
    # STEP_GRAD_FLOOR·(the largest gradient of the model).
    top = max(g.abs().max().item() for g in cpu_grads.values())
    ratios = {n: ((card_grads[n] - g).abs().max().item()
                  / max(g.abs().max().item(), STEP_GRAD_FLOOR * top))
              for n, g in cpu_grads.items()}
    worst = max(ratios, key=ratios.get)
    vanishing = sorted(n for n, g in cpu_grads.items()
                       if g.abs().max().item() < STEP_GRAD_FLOOR * top)
    log({"check": "f32_step_card_vs_cpu", "loss_cpu": cpu_loss, "loss_card": card_loss,
         "loss_rel_diff": rel, "loss_rtol": STEP_LOSS_RTOL,
         "worst_grad_diff_over_max": ratios[worst], "worst_grad": worst,
         "grad_tol": STEP_GRAD_TOL, "grads_floored": vanishing})
    if not (rel <= STEP_LOSS_RTOL and ratios[worst] <= STEP_GRAD_TOL):
        fail(f"float32 step on the card disagrees with the CPU: loss {rel}, "
             f"grad {worst} {ratios[worst]}")


def train_numbers(dev, trainer, card: str) -> dict:
    """ms per train step (median of steady steps, CUDA events), samples/s,
    augmentation ms, one 3D block's depthwise conv forward and backward,
    the idle share and top kernels of a step, peak memory."""
    from torch.profiler import ProfilerActivity, profile

    state, step = trainer.state, trainer.train_step
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randint(0, 256, (BATCH, TRAIN_FRAMES, HEIGHT, WIDTH), dtype=torch.uint8,
                           device=dev, generator=g)
    targets = (torch.rand((BATCH, 2), generator=g, device=dev) > 0.5).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(lambda: step(state, frames, targets, 7), reps=6, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = AugmentConfig()
    host = torch.Generator().manual_seed(0)

    def augment():
        params = sample_augment_params(host, g, BATCH, TRAIN_FRAMES, HEIGHT, WIDTH, cfg)
        return apply_augment(normalize_frames(frames), params, cfg)

    augment_ms = median_ms(augment, reps=6, warmup=2)

    # one 3D block's depthwise conv in training (cuDNN's grouped conv3d,
    # as JAX's lax conv), forward and backward at the step's shape
    x = torch.randn((BATCH, 5, 23, 40, 576), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((3, 3, 3, 1, 576), generator=g, device=dev) / 27 ** 0.5
    x.requires_grad_(True)
    k.requires_grad_(True)
    dy = torch.randn_like(x)

    def dw3d_fwd_bwd():
        torch.autograd.grad(dwconv3d_grouped_conv(x, k), (x, k), dy)

    dw3d_ms = median_ms(dw3d_fwd_bwd, reps=6, warmup=2)
    del x, k, dy
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, frames, targets, 9)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, summed_ms, top = device_time(prof, 1, 160, 15)
    row = {"phase": "train_numbers", "card": card, "batch": BATCH,
           "ms_per_step": step_ms, "samples_per_sec": BATCH / step_ms * 1e3,
           "augment_ms": augment_ms, "dw3d_block_fwd_bwd_ms": dw3d_ms,
           "peak_memory_gb": peak_gb,
           "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "kernel_sum_ms": summed_ms, "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": top}
    log(row)
    return row


def training(dev, card: str, keep_dir: Path) -> dict:
    """The training phase; the best checkpoint is copied into ``keep_dir``
    (the stage-1 experiment of the recipe phase)."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        main_path = train_main_path(dev, Path(tmp))
        log({"phase": "train_main_path_done", "seconds": time.perf_counter() - t0})
        keep_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(main_path["checkpoint"], keep_dir / main_path["checkpoint"].name)
        t0 = time.perf_counter()
        train_numbers(dev, main_path["trainer"], card)
        log({"phase": "train_numbers_done", "seconds": time.perf_counter() - t0})
    del main_path["trainer"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    learning_check(dev)
    f32_step_card_vs_cpu(dev)
    log({"phase": "train_checks_done", "seconds": time.perf_counter() - t0})
    return main_path["launches"]


# --------------------------------------------------------------- phase 5 ---

def path_launches() -> dict:
    """The kernels' counts since the last ``reset_counts``, the warp's by pass."""
    return {**{k.name: k.launches for k in KERNELS},
            "warp_H": warp_ops.KERNEL.launches_by.get("H", 0),
            "warp_V": warp_ops.KERNEL.launches_by.get("V", 0)}


def counted(name: str, launches: dict, fn):
    """Run ``fn`` with the launch counters set to 0 just before; record its
    path's counts under ``name``."""
    for k in KERNELS:
        k.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches[name] = path_launches()
    return out


def write_recipe_game(game_dir: Path, label_file: str, events: dict, seed: int) -> None:
    """Two halves of ``RECIPE_FRAMES`` synthetic WIDTH×VIDEO_HEIGHT frames as gray
    stores (``<half>_720p.mkv.gray``, a bright square near each event) with
    their info sidecars, and the label file: ``events`` maps each half to
    {frame: (label, visibility or None)}."""
    classes = sorted({label for half in events.values() for label, _ in half.values()})
    annotations = []
    for half, half_events in events.items():
        src = SyntheticSource(num_frames=RECIPE_FRAMES, height=VIDEO_HEIGHT, width=WIDTH,
                              seed=seed + half,
                              events={f: classes.index(lab) for f, (lab, _) in half_events.items()})
        video = game_dir / f"{half}_720p.mkv"
        write_gray_store(Path(str(video) + ".gray"),
                         (src.fetch_frame(i) for i in range(RECIPE_FRAMES)), VIDEO_HEIGHT,
                         WIDTH, RECIPE_FRAMES)
        Path(str(video) + ".info.json").write_text(json.dumps(
            dict(frame_count=RECIPE_FRAMES, fps=25.0, width=WIDTH, height=VIDEO_HEIGHT)))
        for frame, (label, visibility) in half_events.items():
            seconds = frame // 25
            ann = {"gameTime": f"{half} - {seconds // 60:02d}:{seconds % 60:02d}",
                   "label": label, "position": str(frame * 40)}
            if visibility:
                ann["visibility"] = visibility
            annotations.append(ann)
    (game_dir / label_file).write_text(json.dumps({"annotations": annotations}))


def recipe_config(config: dict, pretrained: bool = False) -> dict:
    """A recipe config cut in depth only: 1 warmup + 1 train epoch of 8
    samples at batch 4 (4 optimizer steps); without ImageNet weights unless
    ``pretrained``, which keeps the config's own setting."""
    config = dict(config, train_epoch_size=8, num_epochs=[1, 1])
    if not pretrained:
        name, kwargs = config["argus_params"]["nn_module"]
        config["argus_params"] = dict(config["argus_params"],
                                      nn_module=(name, dict(kwargs, pretrained=False)))
    return config


@contextlib.contextmanager
def environ(**values):
    """The environment with ``values`` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def recipe_workspace(work: Path):
    """``work`` as the workspace (``BAS_TPU_WORKDIR``; the action splits in
    ``work/splits``) holding one ball game (fold 0's) and one action game as
    gray stores; yields their names."""
    with environ(BAS_TPU_WORKDIR=str(work), BAS_TPU_ACTION_SPLITS=str(work / "splits")):
        game, action_game = ball.fold2games[0][0], "synthetic/action_game"
        write_recipe_game(ball.DOMAIN.soccernet_dir / game, ball.DOMAIN.label_file,
                          BALL_EVENTS, seed=20)
        write_recipe_game(action.DOMAIN.soccernet_dir / action_game, action.DOMAIN.label_file,
                          ACTION_EVENTS, seed=30)
        (work / "splits").mkdir(parents=True)
        for split in ("train", "val"):
            (work / "splits" / f"{split}.json").write_text(json.dumps([action_game]))
        yield game, action_game


def check_map(name: str, results: dict) -> float:
    values = [results[k] for k in ("a_mAP", "a_mAP_visible", "a_mAP_unshown")
              if results[k] is not None]
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        fail(f"{name}: an a_mAP is not finite in [0, 1]: {values}")
    return results["a_mAP"]


def stage2_action(dev, launches: dict) -> None:
    """Stage 2: ``action_sampling_weights_002`` through the action train
    CLI's path (``cli/action_train.py::train_experiment``)."""
    config = recipe_config(load_experiment_config("action_sampling_weights_002", action.DOMAIN))
    best = counted("action_train", launches, lambda: action_train.train_experiment(
        "action_sampling_weights_002", config, device=dev))
    got = launches["action_train"]
    losses = [best.get("train_loss"), best.get("val_loss")]
    ckpt = get_best_checkpoint_path(action.DOMAIN.experiments_dir / "action_sampling_weights_002")
    _, params = load_checkpoint(ckpt)
    classes = params["nn_module"][1]["num_classes"]
    log({"phase": "stage2_action_train", "launches": got, "losses": losses,
         "num_classes": classes, "checkpoint": ckpt.name})
    if classes != 15 or not all(x is not None and math.isfinite(x) for x in losses):
        fail(f"action training: {classes} classes, losses {losses}")
    if not (got["warp_H"] == got["warp_V"] == 4 and got["gem"] >= 4):
        fail(f"action training did not launch the warp per step and GeM: {got}")


def stage3_ball(dev, game: str, launches: dict) -> None:
    """Stage 3: ``ball_tuning_001`` from the action checkpoint through
    ``resolve_stage_pretrain``, its hard negatives read from the stage-1
    predictions of the game; every tensor but the classifier must start at
    the action checkpoint's value."""
    config = recipe_config(load_experiment_config("ball_tuning_001", ball.DOMAIN))
    pretrain = resolve_stage_pretrain(config, ball.DOMAIN, 0, action.DOMAIN)
    save_dir = ball.DOMAIN.experiments_dir / "ball_tuning_001" / "fold_0"
    start = Trainer(config, list(ball.classes), save_dir, device=dev).init_state(pretrain)
    start = {k: v.detach().cpu() for k, v in start.model.state_dict().items()}
    action_state = flax_tree_to_state_dict(pretrain)
    skipped = sorted(k for k in start if start[k].shape != action_state[k].shape)
    differ = [k for k in start if k not in skipped
              and not torch.equal(start[k], action_state[k].to(start[k].dtype))]
    if skipped != ["classifier.bias", "classifier.weight"] or differ:
        fail(f"stage 3 transfer: skipped {skipped}, loaded but different {differ[:5]}")
    torch.cuda.empty_cache()
    best = counted("stage3_train", launches, lambda: train_stage(
        config, ball.DOMAIN, save_dir, [game], [game], game2fold=ball.game2fold,
        pretrain_variables=pretrain, device=dev))
    got = launches["stage3_train"]
    log({"phase": "stage3_ball_train", "launches": got, "skipped_by_shape": skipped,
         "loaded": len(start) - len(skipped), "train_loss": best.get("train_loss"),
         "val_average_precision": best.get("val_average_precision")})
    if not math.isfinite(best.get("train_loss", math.nan)):
        fail(f"stage 3 loss not finite: {best}")
    if not (got["warp_H"] == got["warp_V"] == 4 and got["gem"] >= 4):
        fail(f"stage 3 did not launch the warp per step and GeM: {got}")


def labels_at_spots(spotting_path: Path, root: Path, game: str) -> Path:
    """A label tree whose ``Labels-ball.json`` holds one annotation at each
    spot of a spotting JSON."""
    spots = json.loads(spotting_path.read_text())["predictions"]
    (root / game).mkdir(parents=True)
    (root / game / ball.DOMAIN.label_file).write_text(json.dumps({"annotations": [
        {k: p[k] for k in ("gameTime", "label", "position")} for p in spots]}))
    return root


def ball_predict_evaluate(dev, game: str, work: Path, launches: dict) -> dict:
    """Stage 3's best ``.ckpt`` predicted with TTA on, the depthwise kernel
    on and off; each scored at "at1" by both algorithms; the two ensembled,
    zipped, and the zip scored again."""
    ckpt = get_best_checkpoint_path(ball.DOMAIN.experiments_dir / "ball_tuning_001" / "fold_0")
    preds = ball.DOMAIN.predictions_dir
    kernel_dir = preds / "ball_tuning_001" / "cv" / "fold_0"
    default_dir = preds / "ball_tuning_001_default" / "cv" / "fold_0"
    counted("eval_predict", launches, lambda: predict_games(
        ckpt, [game], ball.DOMAIN, kernel_dir, tta=True, device=dev, dw3d_use_kernel=True))
    predict_games(ckpt, [game], ball.DOMAIN, default_dir, tta=True, device=dev,
                  dw3d_use_kernel=False)
    got = launches["eval_predict"]
    if not (got["gem"] > 0 and got["dwconv3d"] > 0):
        fail(f"ball predict did not launch GeM and dwconv3d: {got}")

    def score(labels_root, pred_root, algorithm):
        return evaluate_games(labels_root, pred_root, [game], ball.DOMAIN, metric="at1",
                              algorithm=algorithm)

    spots = labels_at_spots(kernel_dir / game / "results_spotting.json", work / "spots", game)
    out = {}
    for algorithm in ("official", "matcher"):
        out[f"kernel_{algorithm}"] = check_map("kernel path", score(
            ball.DOMAIN.soccernet_dir, kernel_dir, algorithm))
        out[f"default_{algorithm}"] = check_map("default path", score(
            ball.DOMAIN.soccernet_dir, default_dir, algorithm))
        out[f"kernel_at_own_spots_{algorithm}"] = check_map(
            "kernel path at its spots", score(spots, kernel_dir, algorithm))
        out[f"default_at_kernel_spots_{algorithm}"] = check_map(
            "default path at the kernel's spots", score(spots, default_dir, algorithm))
    if out["kernel_at_own_spots_matcher"] != 1.0 or out["kernel_at_own_spots_official"] < 0.99:
        fail(f"labels at the kernel path's own spots do not score 1: {out}")
    for algorithm in ("official", "matcher"):
        gap = abs(out[f"kernel_at_own_spots_{algorithm}"]
                  - out[f"default_at_kernel_spots_{algorithm}"])
        if not gap <= MAP_ATOL:
            fail(f"a_mAP@1 kernel vs default path ({algorithm}): |diff| {gap} > {MAP_ATOL}")

    ens = "ball_tuning_001,ball_tuning_001_default"
    ball_ensemble.main(["--experiments", ens, "--folds", "0"])
    ens_dir = preds / ens / "cv" / "fold_0"
    archive = make_submission_zip(ens_dir, games=[game])
    for algorithm in ("official", "matcher"):
        from_dir = score(ball.DOMAIN.soccernet_dir, ens_dir, algorithm)
        from_zip = score(ball.DOMAIN.soccernet_dir, archive, algorithm)
        if from_zip != from_dir:
            fail(f"the submission zip scores otherwise than its directory ({algorithm})")
        out[f"ensemble_{algorithm}"] = check_map("ensemble", from_dir)
    out["spots_kernel_path"] = len(json.loads(
        (kernel_dir / game / "results_spotting.json").read_text())["predictions"])
    return out


def action_predict_evaluate(dev, launches: dict) -> dict:
    counted("action_predict", launches, lambda: action_predict.predict_split(
        "action_sampling_weights_002", "val", device=dev, dw3d_use_kernel=True))
    got = launches["action_predict"]
    if not (got["gem"] > 0 and got["dwconv3d"] > 0):
        fail(f"action predict did not launch GeM and dwconv3d: {got}")
    out = {}
    for algorithm in ("official", "matcher"):
        results = action_evaluate.evaluate_split("action_sampling_weights_002", "val", algorithm)
        out[f"tight_{algorithm}"] = check_map("action predictions", results)
        out[f"tight_visible_{algorithm}"] = results["a_mAP_visible"]
        out[f"tight_unshown_{algorithm}"] = results["a_mAP_unshown"]
    return out


def recipe_and_evaluation(dev, card: str, work: Path) -> dict:
    """Stages 2 and 3 of the recipe at full width, then ball and action
    predictions scored, ensembled and zipped, on synthetic games in
    ``work`` (whose stage-1 checkpoint the training phase left there).
    Returns the launches of each path."""
    launches: dict = {}
    t0 = time.perf_counter()
    with recipe_workspace(work) as (game, _):
        store_gb = sum(p.stat().st_size for p in work.rglob("*.gray")) / 1e9
        log({"phase": "recipe_data", "store_gb": store_gb,
             "seconds": time.perf_counter() - t0})

        # stage 1's out-of-fold predictions of the game, which stage 3's
        # hard-negative sampling reads: the ball predict CLI on the fold
        ball_predict(["--experiment", "sampling_weights_001", "--folds", "0", "--device", str(dev)])
        stage2_action(dev, launches)
        torch.cuda.empty_cache()
        stage3_ball(dev, game, launches)
        torch.cuda.empty_cache()
        ball_map = ball_predict_evaluate(dev, game, work, launches)
        action_map = action_predict_evaluate(dev, launches)
        seconds = time.perf_counter() - t0
        log({"phase": "recipe_eval", "card": card, "a_mAP_at1_ball": ball_map,
             "a_mAP_tight_action": action_map, "map_atol": MAP_ATOL, "launches": launches})
        log({"phase": "recipe_eval_done", "seconds": seconds})
    return launches


# --------------------------------------------------------------- phase 6 ---

class FramesSource:
    """Frames already decoded, read in order: the ``fetch_frame()`` and
    ``num_frames`` of a video source."""

    def __init__(self, frames: np.ndarray):
        self.num_frames = len(frames)
        self._frames = iter(frames)

    def fetch_frame(self) -> np.ndarray:
        return next(self._frames)


def streaming_vs_chunked(dev, weights, frames: np.ndarray, launches: dict) -> None:
    """The per-frame streaming engine against the chunked engine over the
    414 ``frames`` in bf16 (counted as the ``streaming`` path), then over
    the first 160 in float32."""
    for dtype, n, atol in ((torch.bfloat16, STREAM_FRAMES, PRED_BF16_ATOL),
                           (torch.float32, STREAM_F32_FRAMES, PRED_F32_ATOL)):
        kw = dict(weights=weights, device=dev, tta=True, dtype=dtype)
        c_idx, c_raw, _ = run_video(ChunkedVideoPredictor(chunk_size=32, **kw), frames[:n])
        streaming = StreamingPredictor(**kw)
        get_raw_predictions(streaming, FramesSource(frames[:40]), 40)  # warm-up
        name = "streaming" if dtype == torch.bfloat16 else "streaming_f32"
        t0 = time.perf_counter()
        s_idx, s_raw = counted(name, launches, lambda: get_raw_predictions(
            streaming, FramesSource(frames[:n]), n))
        seconds = time.perf_counter() - t0
        check_outputs(f"streaming engine ({dtype})", s_idx, s_raw, n - SERVE_WINDOW - 1)
        if s_idx != list(c_idx):
            fail(f"streaming and chunked engines cover other indexes ({dtype})")
        agree(f"streaming_vs_chunked_{str(dtype).replace('torch.', '')}", s_raw, c_raw, atol)
        log({"phase": "streaming", "dtype": str(dtype), "frames": n,
             "predictions_per_sec": len(s_idx) / seconds, "launches": launches[name]})


def serving_feed() -> list:
    """The direct serving runs' events over ``SERVE_STREAMS`` streams:
    ``("batch", [(stream, frame index), ...])`` or ``("close", stream)``.
    Stream k starts at tick 2k, one frame per tick; at tick 20 every stream
    sends 2 frames (a uniform backlog), 15 ticks later stream 0 sends 2 and
    the others 1 (ragged); then stream 0 closes (on the device-state engine
    the last slot moves into its row) and opens again from frame 0, and
    every stream runs to the end of its video."""
    pos = {k: 0 for k in range(SERVE_STREAMS)}
    events = []

    def tick(counts: dict) -> None:
        items = []
        for k, n in counts.items():
            n = min(n, SERVE_FRAMES - pos[k])
            items += [(k, pos[k] + j) for j in range(n)]
            pos[k] += n
        if items:
            events.append(("batch", items))

    for t in range(20):
        tick({k: 1 for k in pos if t >= 2 * k})
    tick({k: 2 for k in pos})
    for _ in range(15):
        tick({k: 1 for k in pos})
    tick({k: 2 if k == 0 else 1 for k in pos})
    events.append(("close", 0))
    pos[0] = 0
    while any(p < SERVE_FRAMES for p in pos.values()):
        tick({k: 1 for k in pos})
    return events


def serve_direct(predictor, videos: dict, events: list) -> dict:
    """Run ``events`` through ``predict_batch``; {(stream, life): {predict
    index: prediction}}, a stream's life counting its closes. Each tick's
    predictions are copied to the host once."""
    life = {k: 0 for k in videos}
    out: dict = {}
    for kind, arg in events:
        if kind == "close":
            predictor.close_stream(arg)
            life[arg] += 1
            continue
        results = predictor.predict_batch([(k, videos[k][i], i) for k, i in arg])
        for k, pred, pi in _to_host(results):
            if pred is not None:
                out.setdefault((k, life[k]), {})[pi] = pred
    return out


def fed_per_life(events: list) -> dict:
    """Frames each (stream, life) of ``events`` feeds."""
    life, fed = {}, {}
    for kind, arg in events:
        if kind == "close":
            life[arg] = life.get(arg, 0) + 1
            continue
        for k, _ in arg:
            key = (k, life.get(k, 0))
            fed[key] = fed.get(key, 0) + 1
    return fed


def compare_runs(name: str, got: dict, ref: dict, atol: float, same_keys: bool = True) -> float:
    """Max |diff| of two runs' predictions over the indexes of ``got`` that
    ``ref`` has; with ``same_keys`` both must hold the same indexes."""
    worst = 0.0
    for key, preds in got.items():
        if same_keys and set(preds) != set(ref.get(key, {})):
            fail(f"{name}: {key} has other predict indexes than its reference")
        common = sorted(set(preds) & set(ref[key]))
        if not common:
            fail(f"{name}: {key} has no predict index in common with its reference")
        diff = np.abs(np.stack([preds[i] for i in common]) - np.stack([ref[key][i] for i in common]))
        worst = max(worst, float(diff.max()))
    log({"check": name, "max_abs_diff": worst, "atol": atol})
    if not worst <= atol:
        fail(f"{name}: max|diff| {worst} > {atol}")
    return worst


def serving_engines(dev, weights, videos: dict, launches: dict) -> dict:
    """Host-state engine against a streaming engine per stream, then the
    device-state engine against the host-state engine, on one feed."""
    events = serving_feed()
    expected = {key: n - SERVE_WINDOW + 1 for key, n in fed_per_life(events).items()}
    kw = dict(weights=weights, device=dev, tta=True)
    per_stream = {}
    streaming = StreamingPredictor(**kw)  # get_raw_predictions starts each stream afresh
    for k, frames in videos.items():
        idx, raw = get_raw_predictions(streaming, FramesSource(frames), SERVE_FRAMES)
        per_stream[k] = dict(zip(idx, raw))
    runs = {}
    for name, device_state in (("serve_host", False), ("serve_device", True)):
        predictor = build_engine(device_state=device_state, **kw)
        warm_engine(predictor, SERVE_STREAMS, SERVE_MAX_BATCH)
        t0 = time.perf_counter()
        runs[name] = counted(name, launches, lambda: serve_direct(predictor, videos, events))
        seconds = time.perf_counter() - t0
        counts = {key: len(v) for key, v in runs[name].items()}
        log({"phase": name, "ticks": sum(kind == "batch" for kind, _ in events),
             "predictions_by_stream_life": {f"{k}.{life}": n for (k, life), n in counts.items()},
             "seconds": seconds, "launches": launches[name]})
        if counts != expected:
            fail(f"{name}: predictions per stream life {counts}, expected {expected}")
    compare_runs("serve_host_vs_per_stream",
                 runs["serve_host"], {key: per_stream[key[0]] for key in expected},
                 PRED_BF16_ATOL, same_keys=False)
    compare_runs("serve_device_vs_host", runs["serve_device"], runs["serve_host"], PRED_BF16_ATOL)
    return runs


def http_json(method: str, url: str, data: bytes | None = None,
              timeout: float = 120.0) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/octet-stream")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def serve_http(predictor, videos: dict, prefix: str = "s") -> tuple[dict, dict]:
    """``make_server`` on 127.0.0.1, an ephemeral port; one client thread
    per stream (id ``prefix`` + k) posts its frames, polls ``/results``
    until all of the stream's predictions came back, then closes the
    stream. Returns ({k: {index: probs}}, the ``/v1/stats`` payload with the
    clients' slowest request in seconds); everything started is stopped. A request may take up to 120 s, so a
    slow one shows in ``max_request_s`` instead of failing the run (with
    the stdlib's listen backlog of 5, dropped connection attempts once made
    one request take 63 s on the card); a failed one names its URL and
    seconds."""
    server, service = make_server(predictor, "127.0.0.1", 0, max_batch=SERVE_MAX_BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    want = SERVE_FRAMES - SERVE_WINDOW + 1
    results: dict = {}
    errors: list = []
    slowest = [0.0]

    def timed(method, url, data=None):
        t0 = time.perf_counter()
        try:
            return http_json(method, url, data)
        except urllib.error.HTTPError:
            raise
        except Exception as err:
            raise RuntimeError(f"{method} {url} after {time.perf_counter() - t0:.1f} s: "
                               f"{err!r}") from err
        finally:
            slowest[0] = max(slowest[0], time.perf_counter() - t0)

    def client(k, frames):
        try:
            for i, frame in enumerate(frames):
                url = (f"{base}/v1/streams/{prefix}{k}/frames?index={i}"
                       f"&height={VIDEO_HEIGHT}&width={WIDTH}")
                while True:
                    try:
                        status, _ = timed("POST", url, frame.tobytes())
                        break
                    except urllib.error.HTTPError as err:  # 503: the ingest queue is full
                        if err.code != 503:
                            raise
                        time.sleep(0.01)
                if status != 202:
                    raise RuntimeError(f"stream {k} frame {i}: HTTP {status}")
            deadline = time.perf_counter() + 120
            got = []
            while len(got) < want and time.perf_counter() < deadline:
                _, payload = timed("GET", f"{base}/v1/streams/{prefix}{k}/results?since=0")
                got = payload["results"]
                time.sleep(0.05)
            results[k] = {r["index"]: np.asarray(r["probs"], np.float32) for r in got}
            timed("POST", f"{base}/v1/streams/{prefix}{k}/close", b"")
        except Exception as err:  # reported after the join
            errors.append(f"client {k}: {err!r}")

    try:
        clients = [threading.Thread(target=client, args=(k, frames)) for k, frames in videos.items()]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        if any(c.is_alive() for c in clients) or errors:
            fail(f"HTTP clients did not finish: {errors}")
        _, stats = http_json("GET", f"{base}/v1/stats")
        stats["max_request_s"] = slowest[0]
        # the three slowest ticks, (ms, frames in the tick), in tick order
        ticks = list(zip(service._tick_lat_s, service._tick_batch))
        top = sorted(range(len(ticks)), key=lambda i: ticks[i][0])[-3:]
        stats["slowest_ticks"] = [[i, round(ticks[i][0] * 1e3, 3), ticks[i][1]]
                                  for i in sorted(top)]
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    return results, stats


def serving_http(dev, weights, videos: dict, runs: dict, launches: dict) -> None:
    """The HTTP server with the device-state engine (path ``server``), then
    with the host-state engine (``server_host``), each built and warmed as
    the server CLI does (``build_engine``, ``warm_engine``), against the
    direct runs of the same engines: every stream's 68 predictions must
    come back. Then the same clients again on the same engine, whose every
    tick shape the first run reached has now run once: the tick latency of
    both runs, and the shapes the first run ran that warmup did not."""
    last_life = {}
    for key in runs["serve_device"]:
        last_life[key[0]] = max(last_life.get(key[0], 0), key[1])
    want = SERVE_FRAMES - SERVE_WINDOW + 1
    for name, device_state, direct in (("server", True, "serve_device"),
                                       ("server_host", False, "serve_host")):
        predictor = build_engine(weights=weights, device_state=device_state, tta=True,
                                 device=dev)
        warmed = warm_engine(predictor, SERVE_STREAMS, SERVE_MAX_BATCH)
        warmed_shapes = set(predictor._shapes)
        row = {"phase": name, "warmed_buckets": warmed}
        for run, prefix in (("first", "s"), ("rerun", "r")):
            t0 = time.perf_counter()
            if run == "first":
                results, stats = counted(name, launches, lambda: serve_http(predictor, videos))
                row["unwarmed_shapes"] = sorted(predictor._shapes - warmed_shapes)
            else:
                results, stats = serve_http(predictor, videos, prefix)
            counts = {k: len(v) for k, v in results.items()}
            row[run] = {"predictions": counts, "seconds": time.perf_counter() - t0,
                        "stats": {k: stats.get(k) for k in (
                            "ticks", "tick_latency_ms", "tick_batch_mean", "frames_in",
                            "predictions_out", "max_request_s", "slowest_ticks")}}
            if counts != {k: want for k in videos} or stats["frames_in"] != len(videos) * SERVE_FRAMES:
                fail(f"{name} ({run}): predictions per stream {counts}, "
                     f"frames in {stats['frames_in']}")
            compare_runs(f"{name}_vs_direct" + ("" if run == "first" else "_rerun"),
                         {(k, 0): v for k, v in results.items()},
                         {(k, 0): runs[direct][k, last_life[k]] for k in videos}, PRED_BF16_ATOL)
        row["shapes_new_in_rerun"] = sorted(predictor._shapes - warmed_shapes
                                            - set(row["unwarmed_shapes"]))
        row["launches"] = launches[name]
        log(row)


def tick_latency(dev, weights, card: str) -> None:
    """ms per steady-state tick of both engines at ``TICK_BUCKETS``, TTA on
    (information only): loops of 1 and 9 ticks on features already on the
    card, CUDA events, the difference over 8. A bound on the device and
    launch time of a live tick, which adds the frames' upload, the host's
    bookkeeping and the copy of the results."""
    kw = dict(weights=weights, device=dev, tta=True)
    engines = {"device_state": (build_engine(device_state=True, slot_capacity=max(TICK_BUCKETS),
                                             **kw), device_state_tick_ms),
               "host_state": (build_engine(**kw), device_tick_ms)}
    row = {"phase": "serve_tick_ms", "card": card, "tta": True, "budget_ms": REALTIME_MS}
    for name, (predictor, timer) in engines.items():
        ms = {b: timer(predictor, b, reps=2)[0] for b in TICK_BUCKETS}
        fits = [b for b, t in ms.items() if t <= REALTIME_MS]
        row[name] = ms
        row[f"{name}_largest_bucket_within_budget"] = max(fits) if fits else None
    log(row)


def serving_kernels(dev) -> dict:
    """GeM and the depthwise conv at the serving shapes, against their
    plain versions; GeM there must split H·W (one wrapper launch, two
    device kernels)."""
    rows = {}
    for name, shape in SERVE_GEM_SHAPES.items():
        rows[name] = check_gem(dev, shape, name.removeprefix("gem_pool_"), per_kernel=True)
        if not rows[name]["gem_splits"] > 1:
            fail(f"gem at {shape}: {rows[name]['gem_splits']} H·W splits, expected more than 1")
    rows["dwconv3d_serve"] = check_dwconv(dev, 2, n=SERVE_DW_N, path="serve", per_kernel=True)
    torch.cuda.empty_cache()
    return rows


def serving(dev, weights, video: np.ndarray, card: str) -> tuple[dict, dict]:
    """The serving phase on the inference phase's synthetic ``video``, its
    middle 720 rows; returns the launches of each path and the kernel rows
    at the serving shapes."""
    launches: dict = {}
    t0 = time.perf_counter()
    steps = {}

    def step(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        steps[name] = time.perf_counter() - start
        return out

    rows = step("kernels", serving_kernels, dev)
    # one synthetic 720p video: the streaming engine's, and four 96-frame
    # segments of it, one per live stream
    top = (video.shape[1] - VIDEO_HEIGHT) // 2
    frames = np.ascontiguousarray(video[:STREAM_FRAMES, top:top + VIDEO_HEIGHT])
    videos = {k: frames[k * SERVE_FRAMES:(k + 1) * SERVE_FRAMES] for k in range(SERVE_STREAMS)}
    step("streaming", streaming_vs_chunked, dev, weights, frames, launches)
    runs = step("engines", serving_engines, dev, weights, videos, launches)
    step("http", serving_http, dev, weights, videos, runs, launches)
    step("tick_latency", tick_latency, dev, weights, card)
    for path in ("streaming", "serve_host", "serve_device", "server", "server_host"):
        got = launches[path]
        if not (got["gem"] > 0 and got["dwconv3d"] > 0):
            fail(f"the {path} path did not launch GeM and dwconv3d: {got}")
    log({"phase": "serving_done", "launches": launches, "seconds_by_step": steps,
         "seconds": time.perf_counter() - t0})
    return launches, rows


# --------------------------------------------------------------- phase 7 ---

FOLDS = 7                 # the challenge submission's fold models (domains/ball.py)
FOLD_PARALLEL_FOLDS = 3   # on a 1×2 grid: padded to 4 by repeating fold 0
DP_TRAIN_STEPS = 3
DP_LOSS_ATOL = 1e-6       # float32 losses, world size 1 over NCCL vs no process group
DP_LOSS_RTOL = 1e-5       # float32 losses, N ranks vs one process (the CPU tests' rtol)
DP_TIMED_STEPS = 5
CHUNKS = 3                # the 414-frame video's chunks of 128 predictions
DW_PER_CHUNK = 4          # one dwconv3d launch per 3D block
EXPORT_PROBE = r"""
import json, sys, time
import numpy as np
import torch
from ball_action_spotting_torch.ops import KERNELS
from ball_action_spotting_torch.predict.export import ExportedChunkPredictor

art, frames_path, out_path, device = sys.argv[1:5]
frames = np.load(frames_path)
t0 = time.perf_counter()
sealed = ExportedChunkPredictor(art, device=device)
load_s = time.perf_counter() - t0
n = sealed.chunk_size
sealed.predict_video(iter(enumerate(frames[:n + 30])), n + 30)  # warm-up
for k in KERNELS:
    k.reset_counts()
on_card = device.startswith("cuda")
sync = torch.cuda.synchronize if on_card else (lambda: None)
sync()
t0 = time.perf_counter()
idx, raw = sealed.predict_video(iter(enumerate(frames)), len(frames))
seconds = time.perf_counter() - t0
launches = {k.name: k.launches for k in KERNELS}
new = torch.from_numpy(frames[:n]).to(device)
carry = torch.from_numpy(frames[:sealed.overlap]).to(device)
times = []
with torch.inference_mode():
    for i in range(7):
        sync()
        t1 = time.perf_counter()
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        sealed.chunk(new, carry)
        if on_card:
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            times.append((time.perf_counter() - t1) * 1e3)
np.save(out_path, raw)
targets = [str(node.target) for node in sealed.program.graph.nodes if node.op == "call_function"]
print(json.dumps({"models_imported": "ball_action_spotting_torch.models" in sys.modules,
                  "op_nodes": {name: targets.count(f"bas_torch.{name}.default")
                               for name in ("gem_pool", "dwconv3d", "warp_resample")},
                  "jax_imported": any(m.split(".")[0] in ("jax", "ball_action_spotting_tpu")
                                      for m in sys.modules),
                  "launches": launches, "seconds": seconds, "load_seconds": load_s,
                  "ms_per_chunk": sorted(times[2:])[2], "predictions": len(idx)}))
"""


def expect_launches(name: str, got: dict, gem: int, dw: int) -> None:
    if got["gem"] != gem or got["dwconv3d"] != dw:
        fail(f"{name}: launched GeM {got['gem']} and dwconv3d {got['dwconv3d']} times, "
             f"expected {gem} and {dw}")


def chunk_ms(call, new, carry, reps: int = 5) -> float:
    """Median CUDA-event ms of one chunk program on frames on the card."""
    with torch.inference_mode():
        return median_ms(lambda: call(new, carry), reps=reps)


def fused_phase(dev, folds: list, frames: np.ndarray, card: str, launches: dict):
    """7 fold models in one pass against each fold's single-fold engine;
    wall time of the fused pass against 7 single-fold passes."""
    fused = FusedFoldsPredictor(weights=folds, device=dev, chunk_size=CHUNK, tta=True)
    run_video(fused, frames[:CHUNK + 30])  # warm-up
    idx, raw, secs_fused = counted("fused", launches, lambda: run_video(fused, frames))
    expect_launches("fused", launches["fused"], FOLDS * CHUNKS, FOLDS * CHUNKS * DW_PER_CHUNK)
    singles = [ChunkedVideoPredictor(weights=w, device=dev, chunk_size=CHUNK, tta=True)
               for w in folds]
    runs = [run_video(single, frames) for single in singles]
    if (idx != runs[0][0] or raw.shape != (len(idx), FOLDS, 2)
            or not np.isfinite(raw).all()):
        fail(f"fused: predictions of shape {raw.shape} over {len(idx)} frames")
    diffs = [agree(f"fused_fold_{i}_vs_single_fold", raw[:, i], r, PRED_BF16_ATOL)
             for i, (_, r, _) in enumerate(runs)]
    secs_single = sum(secs for _, _, secs in runs)
    log({"phase": "fused", "card": card, "folds": FOLDS, "frames": len(frames),
         "fused_seconds": secs_fused, "seven_single_passes_seconds": secs_single,
         "fused_over_single_passes": secs_fused / secs_single, "max_abs_diff": max(diffs),
         "launches": launches["fused"]})
    del fused, singles
    torch.cuda.empty_cache()
    return raw, secs_fused


def tiny_cpu_artifact(path: Path):
    """A small model's checkpoint sealed by the export CLI on the CPU (the
    route the CLI always seals; float32, chunk 8), and a 40-frame video."""
    EFFNETV2_ARCHS["efficientnetv2_test"] = TINY_ARCH
    kwargs = dict(model_name="efficientnetv2_test", num_classes=2, num_frames=6, stack_size=3,
                  index_2d_features=4, num_3d_blocks=2, num_3d_features=16,
                  num_3d_stack_proj=16, expansion_3d_ratio=2, se_reduce_3d_ratio=4)
    src = SyntheticSource(num_frames=40, height=64, width=96, seed=1, events={20: 0, 30: 1})
    video = np.stack([src.fetch_frame(i) for i in range(40)])
    model = build_model("multidim_stacker", **kwargs)
    init_weights(model, torch.Generator().manual_seed(7))
    calibrate_bn(model.eval(), torch.from_numpy(video[:6][None]).float() / 255.0)
    params = {"nn_module": ("multidim_stacker", kwargs), "frame_stack_size": 6,
              "frame_stack_step": 2, "frames_processor": ("pad_normalize", {"size": (96, 64)})}
    tree = state_dict_to_flax_tree(model.state_dict(), model)
    ckpt = path.with_suffix(".ckpt")
    save_checkpoint(ckpt, params, tree, tree)
    art = export_model.main(["--checkpoint", str(ckpt), "--output", str(path),
                             "--chunk_size", "8", "--dtype", "float32", "--device", "cpu"])
    return art, video


def op_nodes(program) -> dict:
    """The count of each ``bas_torch`` op's nodes in an exported program."""
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    return {name: targets.count(f"bas_torch.{name}.default")
            for name in ("gem_pool", "dwconv3d", "warp_resample")}


def export_phase(dev, weights, frames: np.ndarray, card: str, launches: dict) -> None:
    """The flagship chunked engine (TTA on) sealed on the card and reloaded
    in a fresh process without the model code, against the live
    frame-carry engine; a CPU-traced artifact on the card against the CPU."""
    live = ChunkedVideoPredictor(weights=weights, device=dev, chunk_size=CHUNK, tta=True,
                                 carry_features=False)
    _, raw_live, _ = run_video(live, frames)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        art = export_chunked_predictor(live, tmp / "flagship.bastorx")
        export_s = time.perf_counter() - t0
        np.save(tmp / "frames.npy", frames)
        out = subprocess.run([sys.executable, "-c", EXPORT_PROBE, str(art),
                              str(tmp / "frames.npy"), str(tmp / "raw.npy"), str(dev)],
                             cwd=Path(__file__).resolve().parent, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            fail(f"the export probe failed:\n{out.stderr[-3000:]}")
        probe = json.loads(out.stdout.strip().splitlines()[-1])
        raw_sealed = np.load(tmp / "raw.npy")
        if probe["models_imported"] or probe["jax_imported"]:
            fail(f"the artifact's loader imported model code or JAX: {probe}")
        if probe["op_nodes"] != {"gem_pool": 1, "dwconv3d": DW_PER_CHUNK, "warp_resample": 0}:
            fail(f"the exported flagship program holds {probe['op_nodes']} custom-op nodes")
        launches["export"] = probe["launches"]
        expect_launches("export", probe["launches"], CHUNKS, CHUNKS * DW_PER_CHUNK)
        diff = agree("export_vs_live_frame_carry", raw_sealed, raw_live, PRED_BF16_ATOL)
        new = torch.from_numpy(frames[:CHUNK]).to(dev)
        carry = torch.from_numpy(frames[:live.overlap]).to(dev)
        live_ms = chunk_ms(live.chunk_frames, new, carry)

        art_cpu, video = tiny_cpu_artifact(tmp / "tiny_cpu.bastorx")
        on_cpu = ExportedChunkPredictor(art_cpu, device="cpu")
        on_card = ExportedChunkPredictor(art_cpu, device=dev)
        cpu_traced_nodes = op_nodes(on_card.program)
        if cpu_traced_nodes != {"gem_pool": 1, "dwconv3d": 2, "warp_resample": 0}:
            fail(f"the CLI's CPU-traced artifact holds {cpu_traced_nodes} custom-op nodes")
        idx_cpu, raw_cpu = on_cpu.predict_video(iter(enumerate(video)), len(video))
        idx_card, raw_card = counted("export_cpu_traced", launches, lambda: on_card.predict_video(
            iter(enumerate(video)), len(video)))
        chunks = -(-len(idx_cpu) // on_card.chunk_size)
        expect_launches("export_cpu_traced", launches["export_cpu_traced"], chunks, 2 * chunks)
        if idx_card != idx_cpu:
            fail("the CPU-traced artifact covers other frames on the card")
        diff_cpu = agree("cpu_traced_artifact_card_vs_cpu", raw_card, raw_cpu, PRED_F32_ATOL)
        log({"phase": "export", "card": card, "artifact_mb": art.stat().st_size / 1e6,
             "export_seconds": export_s, "probe": probe, "max_abs_diff": diff,
             "ms_per_chunk_exported": probe["ms_per_chunk"], "ms_per_chunk_live": live_ms,
             "cpu_traced_max_abs_diff": diff_cpu, "cpu_traced_op_nodes": cpu_traced_nodes,
             "cpu_traced_launches": launches["export_cpu_traced"]})
    del live
    torch.cuda.empty_cache()


class BatchList:
    """A sized loader over batches already read."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_devices(dev) -> list:
    """The grids' devices: every visible card, or the one card twice."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else [dev, dev]


def busy_by_card(predictor, frames: np.ndarray) -> dict:
    """One ``predict_video`` pass under torch.profiler: its wall ms and, per
    card, the union of its kernels' intervals (busy ms) and its idle share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, secs = run_video(predictor, frames)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
    wall_ms = secs * 1e3
    busy = {card: union_us(intervals) / 1e3 for card, intervals in sorted(spans.items())}
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": {card: max(0.0, 1.0 - ms / wall_ms) for card, ms in busy.items()}}


def train_run(dev, config: dict, batches: list) -> dict:
    """``Trainer.train_epoch`` over ``batches`` in float32 (augmentation and
    mixup on) from the trainer's seed, cuDNN deterministic: the losses, the
    kernels' launches and the final parameters."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(config, list(ball.classes), Path(tmp), augment=AugmentConfig(),
                              mixup=Mixup(), device=dev, compute_dtype=torch.float32)
            trainer.init_state()
            losses, step, counts = [], trainer.train_step, {}

            def recording_step(*args):
                aux = step(*args)
                losses.append(float(aux["loss"]))
                return aux

            trainer.train_step = recording_step
            counted("run", counts, lambda: trainer.train_epoch(BatchList(batches), 0))
            params = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"losses": losses, "launches": counts["run"], "params": params}


def ms_per_step(dev, rows: int) -> float:
    """Median ms of ``DP_TIMED_STEPS`` bf16 flagship train steps on one
    fixed batch of ``rows`` rows, after two."""
    trainer = Trainer(flagship_config(), list(ball.classes), Path(tempfile.mkdtemp()),
                      augment=AugmentConfig(), mixup=Mixup(), device=dev)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (rows, TRAIN_FRAMES, HEIGHT, WIDTH),
                                           dtype=np.uint8)).to(dev)
    targets = torch.from_numpy((rng.random((rows, 2)) > 0.7).astype(np.float32)).to(dev)
    times = []
    for _ in range(2 + DP_TIMED_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        float(trainer.train_step(state, frames, targets, 1)["loss"])  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    shutil.rmtree(trainer.save_dir, ignore_errors=True)
    return statistics.median(times[2:])


def params_digest(params: dict) -> str:
    digest = hashlib.sha256()
    for k in sorted(params):
        digest.update(params[k].numpy().tobytes())
    return digest.hexdigest()


def dp_train_worker(rank: int, world: int, port: int, tmp: str) -> None:
    """One rank of the data-parallel training: its rows of the global
    batches through ``train_run`` over NCCL, then its ms per bf16 step at
    ``BATCH`` rows."""
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, backend="nccl")
    try:
        batches = torch.load(Path(tmp) / "batches.pt", weights_only=False)
        rows = process_slice(BATCH, rank, world)
        run = train_run(dev, flagship_config(epoch_size=BATCH * DP_TRAIN_STEPS),
                        [(f[rows], t[rows]) for f, t in batches])
        run["digest"] = params_digest(run["params"])
        if rank:
            del run["params"]
        gc.collect()
        torch.cuda.empty_cache()
        run["ms"] = ms_per_step(dev, BATCH)
        torch.save(run, Path(tmp) / f"rank_{rank}.pt")
    finally:
        multihost.shutdown()


def dp_train(dev, world: int, launches: dict) -> dict:
    """``DP_TRAIN_STEPS`` float32 flagship steps (augmentation and mixup
    on) through ``Trainer.train_epoch`` in ``world`` processes over NCCL,
    one per card, each on its rows of the global batches, against the same
    steps in this process without a process group. cuDNN runs
    deterministic, so that at world size 1 the two runs differ only by the
    data-parallel code. Then ms per bf16 step at ``BATCH`` rows per card
    in the ranks against ``BATCH`` rows on one card here."""
    config = flagship_config(epoch_size=BATCH * DP_TRAIN_STEPS)
    train_loader, _ = flagship_loaders(config, ordered=True)
    batches = [(f.copy(), t.copy()) for f, t in train_loader.epoch(0)]
    ref = train_run(dev, config, batches)
    ms_one = ms_per_step(dev, BATCH)
    gc.collect()
    torch.cuda.empty_cache()  # the first rank's process shares this card
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(batches, Path(tmp) / "batches.pt")
        mp.spawn(dp_train_worker, args=(world, free_port(), tmp), nprocs=world, join=True)
        ranks = [torch.load(Path(tmp) / f"rank_{r}.pt", weights_only=False)
                 for r in range(world)]
    got, want = ranks[0]["losses"], ref["losses"]
    diff = max(abs(a - b) for a, b in zip(got, want))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    # world size 1 runs the same sums as no group; more ranks sum the
    # global batch's BN statistics and gradients in another order
    ok = diff <= DP_LOSS_ATOL if world == 1 else rel <= DP_LOSS_RTOL
    ranks_equal = len({r["digest"] for r in ranks}) == 1
    param_diff = max((ranks[0]["params"][k] - v).abs().max().item()
                     for k, v in ref["params"].items())
    launches["dp_train"] = ranks[0]["launches"]
    row = {"check": f"dp_train_nccl_world_{world}_vs_no_group", "losses": got, "reference": want,
           "max_abs_diff": diff, "max_rel_diff": rel,
           "tolerance": {"atol": DP_LOSS_ATOL} if world == 1 else {"rtol": DP_LOSS_RTOL},
           "ranks_bitwise_equal": ranks_equal, "param_max_abs_diff": param_diff,
           "launches": launches["dp_train"], "ms_per_step_one_card": ms_one,
           "ms_per_step_by_rank": [r["ms"] for r in ranks],
           "samples_per_s_one_card": BATCH * 1e3 / ms_one,
           "samples_per_s_world": BATCH * world * 1e3 / max(r["ms"] for r in ranks)}
    log(row)
    if len(got) != DP_TRAIN_STEPS or not ok or not ranks_equal:
        fail(f"data-parallel train steps disagree: {got} vs {want}, ranks equal {ranks_equal}")
    dp = launches["dp_train"]
    if dp["warp_H"] != DP_TRAIN_STEPS or dp["warp_V"] != DP_TRAIN_STEPS or \
            dp["gem"] < DP_TRAIN_STEPS:
        fail(f"the data-parallel steps did not launch the warp and GeM: {dp}")
    return row


def parallel_phase(dev, weights, folds: list, frames: np.ndarray, raw_main: np.ndarray,
                   fused: tuple, card: str, launches: dict) -> None:
    """Data-parallel predict on an N×1 grid and fold-parallel on a 1×N grid
    of the N visible cards (of the one card twice where only one is
    visible) against one device, then data-parallel training at N ranks."""
    devices = parallel_devices(dev)
    n = len(devices)
    kw = dict(weights=weights, chunk_size=CHUNK, tta=True)
    one = ChunkedVideoPredictor(device=dev, **kw)
    run_video(one, frames[:CHUNK + 30])  # warm-up
    _, _, secs_one = run_video(one, frames)
    del one
    dp = ChunkedVideoPredictor(mesh=make_mesh(n, 1, devices), **kw)
    run_video(dp, frames[:CHUNK + 30])
    idx, raw, secs_dp = counted("data_parallel", launches, lambda: run_video(dp, frames))
    check_outputs("data parallel", idx, raw, len(raw_main))
    expect_launches("data_parallel", launches["data_parallel"], n * CHUNKS,
                    n * CHUNKS * DW_PER_CHUNK)  # each share runs its own head
    diff_dp = agree(f"data_parallel_{n}x1_vs_one_device", raw, raw_main, PRED_BF16_ATOL)
    trace_dp = busy_by_card(dp, frames)
    del dp
    raw_fused, secs_fused = fused
    cards = torch.cuda.device_count()
    k = FOLDS if cards > 1 else FOLD_PARALLEL_FOLDS
    fp = FusedFoldsPredictor(weights=folds[:k], device=dev, chunk_size=CHUNK, tta=True,
                             mesh=make_mesh(1, n, devices), fold_parallel=True)
    run_video(fp, frames[:CHUNK + 30])
    _, raw_fp, secs_fp = counted("fold_parallel", launches, lambda: run_video(fp, frames))
    padded = len(fp.fold_shares)
    expect_launches("fold_parallel", launches["fold_parallel"], padded * CHUNKS,
                    padded * CHUNKS * DW_PER_CHUNK)
    diff_fp = agree(f"fold_parallel_1x{n}_vs_fused", raw_fp, raw_fused[:, :k], PRED_BF16_ATOL)
    trace_fp = busy_by_card(fp, frames)
    del fp
    torch.cuda.empty_cache()
    train = dp_train(dev, cards, launches)
    log({"phase": "parallel", "card": card, "cards": cards,
         "grid_devices": [str(d) for d in devices],
         "one_device_seconds": secs_one, "data_parallel_seconds": secs_dp,
         "data_parallel_speedup": secs_one / secs_dp, "data_parallel_max_abs_diff": diff_dp,
         "data_parallel_trace": trace_dp, "fold_parallel_folds": k,
         "fold_parallel_padded_folds": padded, "fold_parallel_seconds": secs_fp,
         "fused_seconds": secs_fused if k == FOLDS else None,
         "fold_parallel_speedup": secs_fused / secs_fp if k == FOLDS else None,
         "fold_parallel_max_abs_diff": diff_fp, "fold_parallel_trace": trace_fp,
         "train_samples_per_s_speedup":
             train["samples_per_s_world"] / train["samples_per_s_one_card"],
         "launches": {k: launches[k] for k in ("data_parallel", "fold_parallel", "dp_train")}})


def ensemble_export_parallel(dev, weights, frames: np.ndarray, raw_main: np.ndarray,
                             card: str) -> dict:
    """Phase 7: the fused ensemble, the sealed export and the parallel paths;
    returns each path's launches."""
    launches: dict = {}
    t0 = time.perf_counter()
    folds = [weights] + [(flagship_weights(dev, frames, seed), PARAMS)
                         for seed in range(1, FOLDS)]
    fused = fused_phase(dev, folds, frames, card, launches)
    log({"phase": "fused_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    export_phase(dev, weights, frames, card, launches)
    log({"phase": "export_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    parallel_phase(dev, weights, folds, frames, raw_main, fused, card, launches)
    log({"phase": "parallel_done", "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------- phase 8 ---

PHASE8_STAGES = {"ball_action": "sampling_weights_001", "action": "action_sampling_weights_002"}
MULTICHAN_BATCH = 2     # multichan_stacker forward over (2, 15, 3, HEIGHT, WIDTH)
CLASSIFIER_BATCH = 4    # classifier2d over (4, 3, HEIGHT, WIDTH)
# the port's module names → the reference's (timm encoder blocks, the
# argus MultiDimStacker's projections and nested 3D norms), applied in order
REFERENCE_NAMES = [
    (r"blocks_(\d+)_(\d+)\.", r"blocks.\1.\2."),
    (r"^conv2d_projection_conv\.", "conv2d_projection.0."),
    (r"^conv2d_projection_bn\.", "conv2d_projection.1."),
    (r"^conv3d_projection_conv\.", "conv3d_projection.0."),
    (r"^conv3d_projection_bn\.", "conv3d_projection.1."),
    (r"^conv3d_encoder_(\d+)\.(bn\d)\.", r"conv3d_encoder.\1.\2.bn3d."),
    (r"^conv3d_encoder_(\d+)\.", r"conv3d_encoder.\1."),
]


def reference_name(name: str) -> str:
    for pattern, repl in REFERENCE_NAMES:
        name = re.sub(pattern, repl, name)
    return name


def timm_layout_encoder(model_name: str, seed: int) -> dict:
    """A seeded timm-layout ``tf_efficientnetv2_*`` state dict as an ImageNet
    file holds it: 3 input channels, the head past the feature tap
    (``conv_head``, ``bn2``, a 1000-class ``classifier``) and every BN's
    ``num_batches_tracked``; numpy float32 (int64 counts)."""
    encoder = init_weights(EfficientNetV2Features(model_name, 4, in_chans=3),
                           torch.Generator().manual_seed(seed))
    sd = {reference_name(k): v.numpy() for k, v in encoder.state_dict().items()}
    rng = np.random.default_rng(seed)
    last = EfficientNetV2Features.feature_channels(model_name, 4)
    sd["conv_head.weight"] = (rng.standard_normal((1280, last, 1, 1))
                              / math.sqrt(last)).astype(np.float32)
    for leaf, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                        ("running_var", 1.0)):
        sd[f"bn2.{leaf}"] = np.full(1280, value, np.float32)
    sd["classifier.weight"] = (rng.standard_normal((1000, 1280)) / math.sqrt(1280)).astype(
        np.float32)
    sd["classifier.bias"] = np.zeros(1000, np.float32)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.removesuffix("running_mean") + "num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def write_safetensors(path: Path, sd: dict) -> None:
    """``sd`` as a ``.safetensors`` file, written here: an 8-byte
    little-endian header length, the JSON header (dtype, shape, byte
    offsets), then the raw little-endian bytes."""
    header, blobs, offset = {}, [], 0
    for name, arr in sd.items():
        arr = np.ascontiguousarray(arr)
        blob = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": {np.float32: "F32", np.int64: "I64"}[arr.dtype.type],
                        "shape": list(arr.shape), "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def encoder_differs(state: dict, sd: dict) -> list:
    """The encoder entries of a port model's ``state`` that are not bitwise
    the timm file's tensor of the same reference name."""
    prefix = "conv2d_encoder."
    return [k for k, v in state.items() if k.startswith(prefix)
            and not torch.equal(v.cpu(), torch.from_numpy(sd[reference_name(k[len(prefix):])]))]


def pretrained_stages(dev, work: Path, launches: dict) -> dict:
    """Stages 1 and 2 as shipped (``pretrained=True``), cut in depth only,
    from a timm-layout file: stage 1's ``.safetensors`` under the full timm
    name, stage 2's ``.pth`` under the bare arch name, each in its own
    ``BAS_TPU_PRETRAINED_DIR``. The encoder's weights and BN statistics at
    init must be bitwise the file's; the warp runs twice and GeM at least
    once per step; losses finite."""
    out = {}
    with recipe_workspace(work) as (game, _):
        for i, domain in enumerate((ball.DOMAIN, action.DOMAIN)):
            name = PHASE8_STAGES[domain.name]
            config = recipe_config(load_experiment_config(name, domain), pretrained=True)
            nn_kwargs = config["argus_params"]["nn_module"][1]
            if nn_kwargs.get("pretrained") is not True:
                fail(f"{name} does not ship pretrained=True: {nn_kwargs}")
            sd = timm_layout_encoder(nn_kwargs["model_name"], seed=10 + i)
            weights_dir = work / f"pretrained_{name}"
            weights_dir.mkdir()
            if i == 0:
                path = weights_dir / f"{nn_kwargs['model_name']}.safetensors"
                write_safetensors(path, sd)
            else:  # the bare arch name, the second name the trainer tries
                bare = nn_kwargs["model_name"].replace("tf_", "").split(".")[0]
                path = weights_dir / f"{bare}.pth"
                torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
            save_dir = work / "phase8" / name
            with environ(BAS_TPU_PRETRAINED_DIR=str(weights_dir)):
                start = Trainer(config, list(domain.classes), save_dir / "init",
                                device=dev).init_state()
                differ = encoder_differs(start.model.state_dict(), sd)
                del start
                if differ:
                    fail(f"{name}: encoder at init differs from {path.name}: {differ[:5]}")
                torch.cuda.empty_cache()
                if domain is ball.DOMAIN:
                    games = dict(train_games=[game], val_games=[game], game2fold=ball.game2fold)
                else:
                    games = dict(train_games=action.load_games_list("train"),
                                 val_games=action.load_games_list("val"))
                path_name = f"stage{i + 1}_pretrained"
                best = counted(path_name, launches, lambda: train_stage(
                    config, domain, save_dir, device=dev, **games))
            got = launches[path_name]
            steps = sum(config["num_epochs"]) * -(-config["train_epoch_size"]
                                                  // config["batch_size"])
            losses = [best.get("train_loss"), best.get("val_loss")]
            log({"phase": path_name, "experiment": name, "file": path.name,
                 "file_bytes": path.stat().st_size, "encoder_tensors_bitwise": True,
                 "launches": got, "steps": steps, "losses": losses})
            if not all(x is not None and math.isfinite(x) for x in losses):
                fail(f"{name} from {path.name}: losses {losses}")
            if not (got["warp_H"] == got["warp_V"] == steps and got["gem"] >= steps):
                fail(f"{name} did not launch the warp twice and GeM once per step: {got}")
            out[name] = losses
            torch.cuda.empty_cache()
    return out


def reference_checkpoint(dev, weights, frames: np.ndarray, raw_main: np.ndarray, work: Path,
                         launches: dict):
    """A reference argus ``.pth`` of the flagship (EMA and raw weights, the
    reference's names) beside a lower-scored ``.ckpt`` of the same weights:
    discovery picks the ``.pth``; both load to the same state bitwise; the
    chunked engine predicts the video from each (TTA on), as the inference
    phase's main path (``raw_main``) did from the same weights; the ``.pth``
    is a stage-3 stage pretrain. Returns the ``.pth`` predictions and path."""
    state, params = weights
    raw_state = {k: v * 1.01 for k, v in state.items()}
    directory = work / "reference"
    directory.mkdir()
    pth = directory / "model-012-0.900000.pth"
    torch.save({"model_name": "BallActionModel",
                "params": dict(params, device=["cuda:0"], amp=True, iter_size=1),
                "nn_state_dict": {reference_name(k): v for k, v in state.items()},
                "no_ema_nn_state_dict": {reference_name(k): v for k, v in raw_state.items()}},
               pth)
    model = build_model("multidim_stacker", **params["nn_module"][1])
    ckpt = directory / "model-011-0.800000.ckpt"
    save_checkpoint(ckpt, params, state_dict_to_flax_tree(state, model),
                    state_dict_to_flax_tree(raw_state, model))
    best = get_best_checkpoint_path(directory)
    if best != pth:
        fail(f"get_best_checkpoint_path picked {best}, not the higher-scored {pth.name}")
    for use_ema, source in ((True, state), (False, raw_state)):
        from_pth = load_inference_variables(pth, use_ema=use_ema, fold_bn=False)[0]
        from_ckpt = load_inference_variables(ckpt, use_ema=use_ema, fold_bn=False)[0]
        differ = [k for k in source if not (torch.equal(from_pth[k], source[k])
                                            and torch.equal(from_ckpt[k], source[k]))]
        if differ or sorted(from_pth) != sorted(source):
            fail(f".pth (use_ema={use_ema}) state differs from the .ckpt's: {differ[:5]}")

    engine = ChunkedVideoPredictor(pth, device=dev, chunk_size=CHUNK, tta=True)
    run_video(engine, frames[:CHUNK + 30])  # warm-up
    idx, raw_pth, _ = counted("pth_predict", launches, lambda: run_video(engine, frames))
    check_outputs("predictions from the .pth", idx, raw_pth, len(raw_main))
    expect_launches("pth_predict", launches["pth_predict"], CHUNKS, CHUNKS * DW_PER_CHUNK)
    del engine
    _, raw_ckpt, _ = run_video(ChunkedVideoPredictor(ckpt, device=dev, chunk_size=CHUNK,
                                                     tta=True), frames)
    diff = agree("pth_vs_ckpt_predictions", raw_pth, raw_ckpt, PRED_BF16_ATOL)
    diff_main = agree("pth_vs_main_path_predictions", raw_pth, raw_main, PRED_BF16_ATOL)

    config = recipe_config(load_experiment_config("ball_tuning_001", ball.DOMAIN))
    pretrain, _ = resolve_pretrain_variables(pth)
    start = Trainer(config, list(ball.classes), work / "stage3_from_pth",
                    device=dev).init_state(pretrain)
    start_state = start.model.state_dict()
    differ = [k for k in state if not torch.equal(start_state[k].cpu(), state[k])]
    del start, start_state
    if differ:
        fail(f"stage 3 from the .pth: tensors not loaded: {differ[:5]}")
    log({"phase": "reference_pth", "picked": best.name, "state_bitwise": True,
         "pth_vs_ckpt_max_abs_diff": diff, "pth_vs_main_path_max_abs_diff": diff_main,
         "launches": launches["pth_predict"],
         "stage3_pretrain_tensors_loaded": len(state)})
    return raw_pth, pth


def s2d_stem(dev, pth: Path, raw_pth: np.ndarray, frames: np.ndarray, launches: dict) -> None:
    """``PredictorBase(s2d_stem=True)`` against the standard stem on the same
    checkpoint: bf16 over the video (TTA on), float32 with TF32 off over its
    first 46 frames."""
    engine = ChunkedVideoPredictor(pth, device=dev, chunk_size=CHUNK, tta=True, s2d_stem=True)
    run_video(engine, frames[:CHUNK + 30])
    idx, raw, _ = counted("s2d_predict", launches, lambda: run_video(engine, frames))
    check_outputs("s2d stem", idx, raw, len(raw_pth))
    expect_launches("s2d_predict", launches["s2d_predict"], CHUNKS, CHUNKS * DW_PER_CHUNK)
    del engine
    diff_bf16 = agree("s2d_vs_standard_stem_bf16", raw, raw_pth, PRED_BF16_ATOL)
    short = frames[:46]
    f32 = {s2d: run_video(ChunkedVideoPredictor(pth, device=dev, chunk_size=8,
                                                dtype=torch.float32, s2d_stem=s2d), short)[1]
           for s2d in (False, True)}
    diff_f32 = agree("s2d_vs_standard_stem_f32", f32[True], f32[False], PRED_F32_ATOL)
    log({"phase": "s2d_stem", "bf16_max_abs_diff": diff_bf16, "f32_max_abs_diff": diff_f32,
         "launches": launches["s2d_predict"]})


def color_clips(frames: np.ndarray, count: int, length: int) -> torch.Tensor:
    """``count`` (length, 3, H, W) uint8 clips from the gray video (every
    second frame; channels the frame, its negative and the next frame)."""
    clips = []
    for b in range(count):
        idx = np.arange(b * 2 * length, (b + 1) * 2 * length, 2) % (len(frames) - 1)
        clips.append(np.stack([frames[idx], 255 - frames[idx], frames[idx + 1]], axis=1))
    return torch.from_numpy(np.stack(clips))


def multichan(dev, frames: np.ndarray, launches: dict) -> None:
    """``multichan_stacker`` (3 channels, the flagship geometry) over
    (MULTICHAN_BATCH, 15, 3, H, W): the depthwise kernel's route against the
    grouped conv's, bf16."""
    kwargs = dict(NN_KWARGS, num_chans=3)
    models = {}
    for use_kernel in (True, False):
        model = build_model("multichan_stacker", dtype=torch.bfloat16,
                            dw3d_use_kernel=use_kernel, **kwargs)
        init_weights(model, torch.Generator().manual_seed(5))
        models[use_kernel] = model.to(dev).eval()
    x = color_clips(frames, MULTICHAN_BATCH, kwargs["num_frames"]).to(dev).float() / 255.0
    calibrate_bn(models[True], x)
    models[False].load_state_dict(models[True].state_dict())
    with torch.no_grad():
        out = counted("multichan", launches, lambda: torch.sigmoid(models[True](x).float()))
        ref = torch.sigmoid(models[False](x).float())
    got = launches["multichan"]
    diff = agree("multichan_kernel_vs_default", out.cpu().numpy(), ref.cpu().numpy(),
                 PRED_BF16_ATOL)
    log({"phase": "multichan", "input": list(x.shape), "max_abs_diff": diff, "launches": got})
    if not (got["gem"] >= 1 and got["dwconv3d"] == kwargs["num_3d_blocks"]):
        fail(f"multichan did not launch GeM and dwconv3d once per 3D block: {got}")


def classifier2d(dev, frames: np.ndarray, launches: dict) -> None:
    """``classifier2d`` (b0, GeM) over (CLASSIFIER_BATCH, 3, H, W): one bf16
    forward and backward in training mode, then, on the weights it left,
    the BN-folded forward against the unfolded one in float32 (TF32 off),
    where the fold's own error is not lost in bf16 rounding through the
    encoder's depth."""
    kwargs = dict(model_name=NN_KWARGS["model_name"], num_classes=2, in_chans=3, pool="gem")
    model = build_model("classifier2d", dtype=torch.bfloat16, **kwargs)
    init_weights(model, torch.Generator().manual_seed(6))
    model.to(dev).eval()
    x = color_clips(frames, CLASSIFIER_BATCH, 1)[:, 0].to(dev).float() / 255.0
    calibrate_bn(model, x)
    targets = torch.tensor([[1.0, 0.0], [0.0, 1.0]] * (CLASSIFIER_BATCH // 2) + [[1.0, 1.0]]
                           * (CLASSIFIER_BATCH % 2), device=dev)
    model.train()

    def step():
        loss = F.binary_cross_entropy_with_logits(model(x), targets)
        loss.backward()
        return loss

    loss = counted("classifier2d_train", launches, step).item()
    grads = [p.grad for p in model.parameters()]
    if not (math.isfinite(loss) and all(g is not None and torch.isfinite(g).all() for g in grads)):
        fail(f"classifier2d train step: loss {loss}, a gradient missing or not finite")
    state = model.state_dict()
    model.eval()
    model.dtype = torch.float32  # the parameters are stored in float32
    folded = build_model("classifier2d", bn_folded=True, **kwargs)
    folded.load_state_dict(fold_bn_state_dict(state))
    folded.to(dev).eval()
    with torch.no_grad():
        ref = torch.sigmoid(model(x))
        out = counted("classifier2d_folded", launches, lambda: torch.sigmoid(folded(x)))
    diff = agree("classifier2d_folded_vs_unfolded_f32", out.cpu().numpy(), ref.cpu().numpy(),
                 PRED_F32_ATOL)
    log({"phase": "classifier2d", "input": list(x.shape), "loss": loss, "max_abs_diff": diff,
         "launches": {k: launches[k] for k in ("classifier2d_train", "classifier2d_folded")}})
    for path in ("classifier2d_train", "classifier2d_folded"):
        if not launches[path]["gem"] >= 1:
            fail(f"{path} did not launch GeM: {launches[path]}")


def family_kernels(dev) -> dict:
    """GeM and the depthwise conv at the multi-channel stacker's shapes
    (its batch of MULTICHAN_BATCH clips), against their plain versions."""
    rows = {"gem_pool_multichan": check_gem(dev, (MULTICHAN_BATCH, 23, 40, 5 * 256),
                                            "multichan", per_kernel=True),
            "dwconv3d_multichan": check_dwconv(dev, 1, n=MULTICHAN_BATCH, path="multichan",
                                               per_kernel=True)}
    torch.cuda.empty_cache()
    return rows


def weights_and_family(dev, card: str, weights, frames: np.ndarray, raw_main: np.ndarray,
                       work: Path) -> tuple[dict, dict]:
    """Phase 8: ImageNet weight files and reference ``.pth`` checkpoints,
    the s2d stem, ``multichan_stacker`` and ``classifier2d``, at the
    flagship's width on the inference phase's ``weights``, video and main
    path predictions; returns each path's launches and the kernel rows at
    the new shapes."""
    launches: dict = {}
    t0 = time.perf_counter()
    steps = {}

    def step(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        steps[name] = time.perf_counter() - start
        return out

    rows = step("kernels", family_kernels, dev)
    losses = step("pretrained_stages", pretrained_stages, dev, work, launches)
    raw_pth, pth = step("reference_pth", reference_checkpoint, dev, weights, frames, raw_main,
                        work, launches)
    step("s2d_stem", s2d_stem, dev, pth, raw_pth, frames, launches)
    step("multichan", multichan, dev, frames, launches)
    step("classifier2d", classifier2d, dev, frames, launches)
    log({"phase": "weights_and_family_done", "card": card, "losses": losses,
         "launches": launches, "seconds_by_step": steps, "seconds": time.perf_counter() - t0})
    return launches, rows


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    build_kernels()

    t0 = time.perf_counter()
    # the inference main path runs hflip TTA, so its shapes are the
    # num_tta=2 ones; the TTA-off shapes are timed beside them
    check_gem(dev, (CHUNK * 5, 23, 40, 256), "inference, TTA off")
    check_dwconv(dev, 1)
    check_dwconv_edges(dev)
    check_gem_edges(dev)
    check_warp_edges(dev)
    torch.cuda.empty_cache()
    rows = {
        "gem_pool_inference": check_gem(dev, (2 * CHUNK * 5, 23, 40, 256), "inference"),
        "dwconv3d": check_dwconv(dev, 2),
        "gem_pool_train": check_gem(dev, (BATCH, 23, 40, 5 * 256), "train"),
    }
    torch.cuda.empty_cache()
    warp_rows = {(axis, dtype): check_warp(dev, axis, dtype)
                 for dtype in (torch.bfloat16, torch.float32) for axis in ("rows", "columns")}
    # the augmentation warps in bf16: its H and V passes are the main path's
    rows["warp_resample_h"] = warp_rows["rows", torch.bfloat16]
    rows["warp_resample_v"] = warp_rows["columns", torch.bfloat16]
    log({"phase": "kernel_checks_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    launches, weights, video, raw_main = flagship(dev, card)
    log({"phase": "inference_done", "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        t0 = time.perf_counter()
        train_launches = training(dev, card, work / "data" / "ball_action" / "experiments"
                                  / "sampling_weights_001" / "fold_0")
        log({"phase": "training_done", "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        recipe_launches = recipe_and_evaluation(dev, card, work)
    torch.cuda.empty_cache()
    serve_launches, serve_rows = serving(dev, weights, video, card)
    rows.update(serve_rows)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_launches = ensemble_export_parallel(dev, weights, video, raw_main, card)
    log({"phase": "ensemble_export_parallel_done", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        family_launches, family_rows = weights_and_family(dev, card, weights, video, raw_main,
                                                          Path(work))
    rows.update(family_rows)

    # one row per kernel and main path; the warp's H and V passes, two
    # launches of one kernel at different shapes and access patterns, each
    # have their own row, launches and bound. ``launches`` is the row's main
    # path; ``launches_by_path`` adds the recipe and serving phases' paths of
    # the same kind (inference or training), each counted from 0. GeM pools
    # 5·256 channels on the paths through ``forward_3d`` + ``forward_head``
    # (streaming, host-state) and 256 on those through ``forward_3d_head``
    # (device-state tick).
    serving_paths = {path: serve_launches[path] for path in
                     ("streaming", "serve_host", "serve_device", "server", "server_host")}
    new_inference_paths = {path: new_launches[path] for path in
                           ("fused", "export", "export_cpu_traced", "data_parallel",
                            "fold_parallel")}
    inference_paths = {"inference": launches, "eval_predict": recipe_launches["eval_predict"],
                       "action_predict": recipe_launches["action_predict"], **serving_paths,
                       **new_inference_paths, "pth_predict": family_launches["pth_predict"],
                       "s2d_predict": family_launches["s2d_predict"]}
    training_paths = {"train": train_launches, "action_train": recipe_launches["action_train"],
                      "stage3_train": recipe_launches["stage3_train"],
                      "dp_train": new_launches["dp_train"],
                      "stage1_pretrained": family_launches["stage1_pretrained"],
                      "stage2_pretrained": family_launches["stage2_pretrained"]}
    sources = {
        "gem_pool_inference": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                               "ball_action_spotting_tpu/ops/pallas_gem.py:64", inference_paths),
        "gem_pool_train": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                           "ball_action_spotting_tpu/ops/pallas_gem.py:64",
                           {**training_paths,
                            "classifier2d_train": family_launches["classifier2d_train"]}),
        "dwconv3d": ("dwconv3d", "ball_action_spotting_torch/csrc/dwconv3d.cu",
                     "ball_action_spotting_tpu/ops/pallas_dwconv3d.py:105", inference_paths),
        "warp_resample_h": ("warp_H", "ball_action_spotting_torch/csrc/warp.cu",
                            "ball_action_spotting_tpu/ops/pallas_warp.py:96", training_paths),
        "warp_resample_v": ("warp_V", "ball_action_spotting_torch/csrc/warp.cu",
                            "ball_action_spotting_tpu/ops/pallas_warp.py:96", training_paths),
        "gem_pool_serve_host": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                                "ball_action_spotting_tpu/ops/pallas_gem.py:64",
                                {p: serving_paths[p] for p in
                                 ("serve_host", "streaming", "server_host")}),
        "gem_pool_serve_device": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                                  "ball_action_spotting_tpu/ops/pallas_gem.py:64",
                                  {p: serving_paths[p] for p in ("serve_device", "server")}),
        "dwconv3d_serve": ("dwconv3d", "ball_action_spotting_torch/csrc/dwconv3d.cu",
                           "ball_action_spotting_tpu/ops/pallas_dwconv3d.py:105", serving_paths),
        "gem_pool_multichan": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                               "ball_action_spotting_tpu/ops/pallas_gem.py:64",
                               {"multichan": family_launches["multichan"]}),
        "dwconv3d_multichan": ("dwconv3d", "ball_action_spotting_torch/csrc/dwconv3d.cu",
                               "ball_action_spotting_tpu/ops/pallas_dwconv3d.py:105",
                               {"multichan": family_launches["multichan"]}),
    }
    kernels = []
    for name, (kernel, source, replaces, paths) in sources.items():
        row = rows[name]
        by_path = {path: counts[kernel] for path, counts in paths.items()}
        if not all(n > 0 for n in by_path.values()):
            fail(f"{name} was not launched on every path it runs on: {by_path}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[next(iter(paths))], "launches_by_path": by_path,
            "max_abs_err": row["max_abs_diff"],
            "ms": row["kernel_ms"], "direct_ms": row["direct_ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
    if any(not (math.isfinite(k["ms"]) and math.isfinite(k["device_ms"])) for k in kernels):
        fail("a kernel time is not finite")
    log(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
