"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): kernels, the
flagship chunked inference path, the flagship training path, the rest of
the four-stage recipe with its evaluation, the serving path, the
fold-fused ensemble, the sealed export and the parallel paths, the
weight sources and model families (ImageNet files, reference ``.pth``
checkpoints, the s2d stem, ``multichan_stacker``, ``classifier2d``), the
host data path (gray stores, the native gather, the rehearsal CLI),
model parallelism (pipeline- and tensor-parallel training, the serving
mesh, the dryrun), spatial partitioning, and the int8 encoder convs.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase model_parallel   # phases 1 and 10 alone
    python3 chip_smoke.py --phase spatial          # phases 1 and 11 alone
    python3 chip_smoke.py --phase int8             # phases 1 and 12 alone

Phases, in order (any failure exits nonzero; each prints its seconds):

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of ``ball_action_spotting_torch/csrc`` with nvcc and the gray
   store's host gather with g++ (one process per source, all at once),
   printing the build time and ptxas' report.
2. Holds each kernel against its plain PyTorch version at the main paths'
   shapes, and times kernel, plain version and the one PyTorch call that
   computes the same function (CUDA events around the call, median of 10:
   ``kernel_ms``, what a caller pays) and the kernel's own device time
   (torch.profiler over 10 calls, median of per-call sums: ``device_ms``;
   ``direct_ms`` times the op's CUDA function called directly, without the
   ``torch.library`` dispatcher;
   the serving and multi-channel shapes' rows, where the profiler lost
   records, time each call with CUDA events queued behind a sleeping
   kernel, ``device_ms_method``). Prints one JSON
   line per kernel and shape with its bound on an H100 SXM. GeM at the
   inference head's and the train step's head's shapes in bf16, with its
   backward in float32 and bf16, and two runs bit-identical; the depthwise
   conv at the inference shapes in bf16; the warp resample at the train
   step's H-pass and V-pass shapes in bf16 and float32; the folded BN's
   epilogue (``bias_act``) at ``BIAS_ACT_SHAPES`` (the stem's bias + SiLU,
   the 3D head's bn1/bn2 and its bn3 with the skip) in bf16, bit for bit
   the plain sequence, ``library_ms`` PyTorch's unfused passes; the SE gate
   multiply (``se_scale``) at ``SE_SCALE_SHAPES`` (the encoder's stride-16
   and stride-32 maps, the 3D head's at 15 and 33 frames) in bf16, bit for
   bit ATen's multiply, ``library_ms`` ATen's broadcast multiply. Then the edge
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
   card against the CPU; each sealed program must hold one ``bias_act``
   node per folded BN. The parallel paths take every visible card, or
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
9. The host data path, in its own temporary workspace, each stage a
   span of ``utils/profiling.py``'s tracer: two ball games of two halves of
   400 frames at 1280x720 written as gray stores (1.47 GB); batches of the
   flagship's clips (15 frames at step 2; 4 and 128 clips, indexes clamped
   at both ends) gathered into padded 736-row slots by the native reader at
   1, 4 and 8 threads and by the numpy reader, and 128 clips one a call
   from ``num_decode_workers`` threads at once, as the loader asks for
   them, bitwise equal, clips/s and GB/s; the
   flagship trainer (8 steps, 1 validation pass) through
   ``train/pipeline.py``'s datasets over the stores (validation through
   ``make_sequential_factory``, a store unwrapped), then the loader's
   signed share of the fit loop (ms a step with loading against ms a step
   on a batch on the card, 16 steps, 2 reps in turns); two train steps under
   ``device_trace``, whose trace must name the GeM and warp kernels; the
   ball predict CLI from that checkpoint over one game (TTA on), its fps
   beside phase 3's and its predictions within the bf16 tolerance of
   ``ChunkedVideoPredictor`` over the frames as an array;
   ``smooth_scores_batch`` on the card over a half's 2 × 67,500 scores and
   a row shorter than the kernel's radius, against scipy within 2e-3; then
   the steps of ``cli/rehearsal.py`` in process over every fold's and
   challenge game (hard links to the stores), each stage cut in depth as
   in phase 5:
   stage 1 over all folds (stage 3 reads every train game's out-of-fold
   predictions), stages 2-4 on fold 0, the predictions, the ensemble and
   its mAP, with stage 4's losses finite and every step's launches counted.
10. Model parallelism (``model_parallel``), at the flagship's full width
   (``flagship_config``, bf16) on a (1, 2) grid of two cards, or of the one
   card twice: one pipelined step (``parallel/pipeline.py``, n_micro 2,
   augmentation and mixup on, drop rates 0) against the ``iter_size`` = 2
   step on one device from the same weights and batch (loss, predictions,
   every gradient, and after the step every parameter, EMA weight and BN
   buffer), the warp launched on stage 0's card and GeM on stage 1's; a
   ``Trainer.fit`` through ``config["pipeline_parallel"]`` (a warmup and a
   train epoch of 3 steps each, validation on the split EMA, a ``.ckpt``
   that must be byte for byte the unsplit model's), the same launches per
   card; a step over a state split by ``shard_state`` (``min_channels``
   256) against the replicated step, held as the pipelined step is, and
   the state's bytes on each model-axis index; ``MultiStreamPredictor(mesh=)`` on an
   N × 1 grid of the cards against a ``StreamingPredictor`` per stream on
   phase 6's feed, GeM and dwconv3d launched on every data-axis card; the
   dryrun (``cli/dryrun_multichip.py``, every leg OK) over the visible
   cards. Prints ms
   per step of pp, ``iter_size``, tp and one device, and the mesh's tick ms
   by bucket, each beside the card's name and power limit.
11. Spatial partitioning (``spatial``), at the flagship's full width on
   phase 3's weights and video: GeM's band-partial launch at the two bands
   of the TTA-on head, (1280, 12 | 11, 40, 256), and the depthwise kernel
   on the two bands' windows, (256, 5, 13 | 12, 40, 576), each against its
   plain version and timed as in phase 2; ``ChunkedVideoPredictor(mesh=,
   spatial=True)`` on the (1, 2) and (1, 4) grids of the one card repeated
   (on n cards: (1, n) and, where n ≥ 4, (2, n/2)) over the 414-frame
   video, TTA off and on, each run with the launch counters set to 0 and
   held against the unsplit frame-carry engine within 0.02 (bf16), with
   its end-to-end and device fps, band rows at the input and at 1/32, halo
   bytes and cross-band sums per chunk (counted from the windows' shapes)
   and GeM's partial and dwconv3d launches on every band device, and a
   profile of two TTA-off chunk programs (each card's busy ms and idle
   share, top kernels) beside the unsplit engine's; a float32
   run (46 frames, chunk 8, TF32 off) against the unsplit engine within
   1e-4; the flagship stage-1 train step (batch 4, no augmentation) on
   bands over a (1, 2) grid against the unbanded step in float32 under
   deterministic cuDNN (loss, predictions, every gradient), its launches
   counted as the spatial training path (GeM's partial on every band
   device), and ms a step of each in bf16. The main path is the first grid
   with TTA on.
12. The int8 encoder convs (``int8``, ``conv_int8=True``), at the
   flagship's full width on phase 3's weights and video: the 3×3 kernel of
   ``csrc/int8_conv3x3.cu``, the GEMM kernel of ``csrc/int8_gemm.cu`` and
   the conv kernel of ``csrc/int8_conv.cu`` (the shapes the other two
   refuse), which quantize a compute-dtype x on its way to the s8 product
   and dequantize in their epilogue, through the op's CUDA route at
   ``INT8_EDGE_CASES`` (counted as the path ``int8_edges``; on the 3×3
   kernel taps paired at C 16 and a step across taps at C 48, C 8 and 24,
   C_out 16 to 192, odd sizes at stride 2, ragged tiles, float32 and
   float16; on the conv kernel odd O, two passes over C, k 5, 1×1 edge
   shapes, misaligned x, rows TMA cannot read and a 3×3 whose ring does
   not fit; on the GEMM kernel K tails, an M tail below one tile, weights
   in the ring, C_out 1152 over ragged rows, float32; every output and
   int32 sum equal to the plain version's, each case's kernel checked by
   the three launch counters); the five k×k shapes of a TTA-on chunk
   (``INT8_SHAPES``, batch 256) on the 3×3 kernel, three 1×1 shapes
   (``INT8_MM_SHAPES``) on the GEMM kernel and one float32 shape that the
   3×3 kernel refuses (``INT8_CONV_SHAPES``) on the conv kernel, seeded x
   with s_x from ``activation_scale``, exact in int32 and the compute dtype
   against the plain version (quantize, float64 sums in slices of 16
   images, dequantize), timed as in phase 2 beside cuDNN's conv in the
   compute dtype (k×k) or ``torch._int_mm`` on the quantized x (1×1). Then
   the flagship int8 engine (bf16, chunk 128, feature carry): the main path
   TTA on with the launch counters at 0 (5 launches of the 3×3 kernel, 36
   of the GEMM kernel and none of the conv kernel per encoder call, GeM 3,
   dwconv3d 12), a TTA-off chunk whose 41 quantized layers a forward hook
   holds against the plain version on their captured inputs, exactly, the
   drift from phase 3's bf16 predictions (< 0.15), the encoder features on
   32 stacks equal to those of the plain version and their correlation with
   bf16 (logged), device and end-to-end fps of int8 and bf16 in turns, TTA
   off and on, and a chunk profile by op whose separate quantize,
   weight-quantize and dequantize ops and ``_int_mm`` calls are no more
   than bf16's; a line with the GEMM and 3×3 kernels' device ms a TTA-off
   chunk, the GEMM's against the summed byte bound of the 1×1 shapes the
   encoder handed the op in that chunk (recorded at the op), and each
   library's build seconds.
   Then, each path counted from 0: the streaming engine
   against the chunked one, the device-state engine on a feed of 4 streams
   and its tick ms at buckets 1, 8, 16 beside the 40-ms limit, the sp 1×2
   grid against the unsplit engine (and its device fps beside the unsplit
   engine's, TTA on, in turns), the frame-carry engine exported and
   reloaded (41 ``int8_conv2d`` nodes), and the data-share grid on the
   visible cards; each launches the 3×3 and GEMM kernels, GeM and
   dwconv3d.
13. Prints the ``kernels`` JSON line (one row per kernel and main path:
   GeM on the inference and on the training path, the depthwise conv, and
   the warp's H and V passes, each with its own launches and bound, and
   ``launches_by_path``: the recipe, serving, phase-7, -8, -9 and -10 paths
   of the same kind, each of which must launch it; the folded BN's
   epilogue at ``BIAS_ACT_SHAPES`` and the SE gate multiply at
   ``SE_SCALE_SHAPES``, each with every inference path; then GeM and the
   depthwise conv at the serving and the multi-channel shapes, each with
   its paths; then GeM's band-partial launch and the depthwise conv at
   phase 11's band shapes, with the spatial paths, GeM's with the banded
   train step's too; then the int8 3×3 kernel at phase 12's k×k shapes
   with cuDNN's bf16 time beside it and the int8 GEMM kernel at its 1×1
   shapes with ``_int_mm``'s, both with the int8 paths, and the int8 conv
   kernel at its float32 shape with cuDNN's float32 time and the edge
   cases' path), then the device line last.

Float32 comparisons run with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` set False): cuDNN would
otherwise run float32 convolutions in TF32.
"""

from __future__ import annotations

import contextlib
import copy
import csv
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter1d

from ball_action_spotting_torch.cli import (
    action_evaluate,
    action_predict,
    action_train,
    ball_ensemble,
    export_model,
    rehearsal,
)
from ball_action_spotting_torch.cli.dryrun_multichip import dryrun_multichip
from ball_action_spotting_torch.convert import flax_tree_to_state_dict, state_dict_to_flax_tree
from ball_action_spotting_torch.core.indexes import StackIndexesGenerator
from ball_action_spotting_torch.core.postprocess import (
    raw_predictions_to_actions,
    smooth_scores_batch,
)
from ball_action_spotting_torch.core.sampling import ball_sampling_weights
from ball_action_spotting_torch.core.spotting import (
    load_raw_predictions,
    write_game_spotting_results,
)
from ball_action_spotting_torch.core.targets import MaxWindowTargetsProcessor
from ball_action_spotting_torch.data import (
    ClipLoader,
    TrainClipDataset,
    ValClipDataset,
    make_synthetic_video_data,
)
from ball_action_spotting_torch.data.gray_store import (
    LIBRARY as GRAY_STORE_LIBRARY,
    GrayStore,
    GrayStoreSource,
    write_gray_store,
)
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
    same_pad,
    set_dropout_generator,
)
from ball_action_spotting_torch.models.fold_bn import fold_bn_state_dict
from ball_action_spotting_torch.models.quantize import (
    QuantConv,
    abs_max,
    activation_scale,
    quantize,
    weight_scale,
)
from ball_action_spotting_torch.ops import KERNELS
from ball_action_spotting_torch.ops import bias_act as bias_act_ops
from ball_action_spotting_torch.ops import dwconv3d as dw_ops
from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.ops import int8_conv as int8_ops
from ball_action_spotting_torch.ops import se_scale as se_scale_ops
from ball_action_spotting_torch.ops import warp as warp_ops
from ball_action_spotting_torch.native import build_all
from ball_action_spotting_torch.ops.augment import (
    AugmentConfig,
    apply_augment,
    sample_augment_params,
)
from ball_action_spotting_torch.ops.bias_act import bias_act, bias_act_reference
from ball_action_spotting_torch.ops.se_scale import se_scale, se_scale_reference
from ball_action_spotting_torch.ops.dwconv3d import (
    dwconv3d,
    dwconv3d_grouped_conv,
    dwconv3d_reference,
)
from ball_action_spotting_torch.ops.gem import (
    gem_pool,
    gem_pool_partial,
    gem_pool_partial_reference,
    gem_pool_reference,
)
from ball_action_spotting_torch.ops.int8_conv import int8_conv2d, int8_conv2d_reference
from ball_action_spotting_torch.ops.losses import FocalLoss, build_loss
from ball_action_spotting_torch.ops.mixup import Mixup, make_mixup_fn
from ball_action_spotting_torch.parallel import multihost
from ball_action_spotting_torch.parallel.mesh import make_mesh, spatial_bands
from ball_action_spotting_torch.parallel.multihost import process_slice
from ball_action_spotting_torch.parallel.pipeline import make_pp_train_step, place_stages
from ball_action_spotting_torch.parallel.sharding_rules import SHARDS, gathered, shard_state
from ball_action_spotting_torch.parallel.spatial import COUNTS as SP_COUNTS
from ball_action_spotting_torch.parallel.spatial import Bands, bands_of
from ball_action_spotting_torch.predict.__main__ import main as ball_predict
from ball_action_spotting_torch.predict.export import (
    ExportedChunkPredictor,
    export_chunked_predictor,
)
from ball_action_spotting_torch.predict.fused import FusedFoldsPredictor
from ball_action_spotting_torch.predict.multistream import (
    DeviceStateMultiStreamPredictor,
    MultiStreamPredictor,
    device_state_tick_ms,
    device_tick_ms,
)
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
from ball_action_spotting_torch.train.pipeline import (
    build_datasets,
    resolve_stage_pretrain,
    train_stage,
)
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step, normalize_frames
from ball_action_spotting_torch.utils import profiling
from ball_action_spotting_torch.utils.experiments import (
    load_experiment_config,
    num_decode_workers,
)
from ball_action_spotting_torch.utils.recipe import spotting_recipe

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores, which the kernels' arithmetic uses.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SLEEP_CYCLES = 2_000_000  # ~1 ms of a spinning kernel at the H100's clock

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
# The main path's largest folded-BN epilogues in a chunk program (bf16, NHWC
# or (N, T, H, W, C), TTA on): (shape, activation, with the block's skip)
BIAS_ACT_SHAPES = {
    "bias_act_stem": ((2 * CHUNK, 368, 640, 32), "silu", False),  # the encoder's stem
    "bias_act_head": ((2 * CHUNK, 5, 23, 40, 576), "silu", False),  # the 3D head's bn1, bn2
    "bias_act_head_skip": ((2 * CHUNK, 5, 23, 40, 192), "none", True),  # its bn3 and skip
}
# The SE gate multiplies of a chunk program (bf16, TTA on), channels last:
# the encoder's largest at strides 16 and 32 (NCHW maps in channels-last
# memory) and the 3D head's at 15 and 33 frames
SE_SCALE_SHAPES = {
    "se_scale_s16": (2 * CHUNK, 46, 80, 672),
    "se_scale_s32": (2 * CHUNK, 23, 40, 1152),
    "se_scale_head": (2 * CHUNK, 5, 23, 40, 576),
    "se_scale_head_f33": (2 * CHUNK, 11, 23, 40, 576),
}
# ... and the stride-16 one of the space-to-depth stem's encoder, whose maps
# stay NCHW in contiguous memory: a plane per channel
SE_SCALE_PLANES_SHAPE = (2 * CHUNK, 46, 80, 672)
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


def profiled_ms(fn, match: str, reps: int = 10, warmup: int = 2, per_call: int = 1,
                tries: int = 3) -> tuple[float | None, list[int]]:
    """The kernel's own time per call: the median over ``reps`` calls of
    ``fn`` of the summed device time of the ``per_call`` kernels a call
    launches whose name holds ``match`` (torch.profiler, which traces
    ctypes launches like any other), and the launches each window saw. A
    window in which the profiler saw another count than ``per_call · reps``
    launches is profiled again, up to ``tries`` times; then the time is
    None."""
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
                for i in range(0, len(spans), per_call)), seen
    return None, seen


def device_ms(fn, match: str, reps: int = 10, warmup: int = 2, per_call: int = 1,
              tries: int = 3) -> float:
    """``profiled_ms``, failing the run where every window lost launches."""
    ms, seen = profiled_ms(fn, match, reps, warmup, per_call, tries)
    if ms is None:
        fail(f"the profiler saw {seen} launches of {match!r} in windows of {reps} calls, "
             f"expected {per_call * reps}")
    return ms


def kernel_device_ms(fn, match: str, kernel, per_call: int = 1) -> dict:
    """A row's device time: ``profiled_ms`` where a window saw every
    launch, else ``device_ms_events`` (the profiler's windows have lost
    every record of a kernel on the card, ROADMAP C8), with the launches
    the windows saw."""
    ms, seen = profiled_ms(fn, match, per_call=per_call)
    if ms is not None:
        return {"device_ms": ms, "device_ms_method": "per_call_sum"}
    log({"profiler_lost_launches": match, "seen": seen, "expected": per_call * 10})
    return {"device_ms": device_ms_events(fn, kernel, per_call=per_call),
            "device_ms_method": "cuda_events_behind_sleep", "profiler_launches_seen": seen}


def device_ms_events(fn, kernel, reps: int = 10, warmup: int = 2, per_call: int = 1) -> float:
    """The device time of one call of ``fn`` by CUDA events, for the rows
    where torch.profiler's window lost kernel records on the card (7 of 24
    launches at GeM's serving shape; 3 of 12 ``dwconv3d_kernel`` launches at
    the multi-channel shape in each of 3 tries, ROADMAP C8). Each call is
    enqueued behind a ``torch.cuda._sleep`` of ``SLEEP_CYCLES`` on the
    stream, so that its two events bracket its device work alone and not the
    host's launch path; the median of ``reps`` calls. ``kernel``'s launch
    count must grow by exactly one per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    before = kernel.launches
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if kernel.launches - before != per_call * reps:
        fail(f"{kernel.name}: {kernel.launches - before} launches in {reps} timed calls, "
             f"expected {per_call * reps}")
    return statistics.median(times)


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
    """Every kernel's library and the gray store's host library, one
    compiler per source, all started together."""
    t0 = time.perf_counter()
    logs = build_all([*KERNELS, GRAY_STORE_LIBRARY])
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
         "kernels": [k.name for k in KERNELS], "host": [GRAY_STORE_LIBRARY.name],
         "seconds_by_library": {k.name: k.build_seconds for k in (*KERNELS, GRAY_STORE_LIBRARY)}})
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
    takes the device time by ``device_ms_events``."""
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
        **({"device_ms": device_ms_events(lambda: gem_pool(x, p), gem_ops.KERNEL),
            "device_ms_method": "cuda_events_behind_sleep"} if per_kernel else
           kernel_device_ms(lambda: gem_pool(x, p), "gem_", gem_ops.KERNEL, per_call=launches)),
        "plain_ms": median_ms(lambda: gem_pool_reference(x, p)),
        "library_ms": median_ms(
            lambda: x.float().clamp_min(1e-6).pow(p).mean((1, 2)).pow(1.0 / p)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "backward": backward, "grad_rtol": GEM_GRAD_RTOL, "bf16_dx_rounding": GEM_GRAD_ROUND,
        "gem_splits": splits,
    }
    log(row)
    return row


def check_bias_act(dev, shape: tuple, act: str, residual: bool) -> dict:
    """The folded BN's epilogue (bias, ``act``, the skip where ``residual``)
    at one of the main path's shapes in bf16, through the wrapper the model
    calls, against the plain sequence on the same inputs: bit for bit.
    ``library_ms`` times PyTorch's unfused passes, which are the plain
    sequence itself (the bias add, SiLU, the skip add)."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = (4 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
    bias = torch.randn(shape[-1], generator=g, device=dev).to(torch.bfloat16)
    r = (4 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16) if residual else None
    fn = F.silu if act == "silu" else None
    before = bias_act_ops.KERNEL.launches
    out = bias_act(x, bias, fn, r)
    ref = bias_act_reference(x, bias, r, act)
    if bias_act_ops.KERNEL.launches != before + 1:
        fail(f"bias_act ({shape}, {act}): the wrapper did not launch its kernel once")
    if not torch.equal(out.view(torch.int16), ref.view(torch.int16)):
        err = (out.float() - ref.float()).abs().max().item()
        fail(f"bias_act kernel vs plain ({shape}, {act}, skip {residual}): not bit for bit, "
             f"max|diff| {err}")
    del out, ref
    torch.cuda.empty_cache()
    n = x.numel()
    nbytes = n * 2 * (3 if residual else 2) + bias.numel() * 2
    bound_ms, bound_by = bound(nbytes, n * ((5 if act == "silu" else 1) + residual))
    plain_ms = median_ms(lambda: bias_act_reference(x, bias, r, act))
    row = {
        "name": "bias_act", "path": "inference", "shape": list(shape), "dtype": "bfloat16",
        "act": act, "residual": residual, "max_abs_diff": 0.0, "bit_equal": True,
        "kernel_ms": median_ms(lambda: bias_act(x, bias, fn, r)),
        "direct_ms": median_ms(lambda: bias_act_ops.bias_act_cuda(x, bias, r, act)),
        **kernel_device_ms(lambda: bias_act(x, bias, fn, r), "bias_act", bias_act_ops.KERNEL),
        "plain_ms": plain_ms, "library_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(row)
    del x, r
    torch.cuda.empty_cache()
    return row


def check_se_scale(dev, shape: tuple, planes: bool = False) -> dict:
    """The SE gate multiply at one of the main path's shapes (channels
    last) in bf16, through the wrapper the SE modules call, against the
    plain ``x * gate`` on the same inputs: bit for bit. The encoder's maps
    are NCHW in channels-last memory, or in contiguous memory where
    ``planes``, the head's (N, T, H, W, C); ``library_ms`` times ATen's
    broadcast multiply as the modules ran it before the kernel."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = (4 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
    gate = torch.rand(shape[0], shape[-1], generator=g, device=dev).to(torch.bfloat16)
    if planes:
        x = x.movedim(-1, 1).contiguous().movedim(1, -1)
    channels_last = len(shape) == 5
    if channels_last:
        xm, gm = x, gate[:, None, None, None, :]
    else:
        xm, gm = x.permute(0, 3, 1, 2), gate[:, :, None, None]  # NCHW
    se_scale_ops.KERNEL.reset_counts()
    out = se_scale(xm, gm, channels_last)
    ref = xm * gm
    if (se_scale_ops.KERNEL.launches, path_launches()["se_scale_planes"]) != (1, int(planes)):
        fail(f"se_scale ({shape}, planes {planes}): the wrapper did not launch its kernel "
             f"once on {'planes' if planes else 'channels innermost'}")
    if out.stride() != ref.stride() or not torch.equal(out.view(torch.int16),
                                                       ref.view(torch.int16)):
        err = (out.float() - ref.float()).abs().max().item()
        fail(f"se_scale kernel vs plain ({shape}): not bit for bit, max|diff| {err}")
    del out, ref
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound(x.numel() * 2 * 2 + gate.numel() * 2, x.numel())
    call = lambda: se_scale(xm, gm, channels_last)  # noqa: E731
    row = {
        "name": "se_scale", "path": "inference", "shape": list(shape), "dtype": "bfloat16",
        "planes": planes,
        "max_abs_diff": 0.0, "bit_equal": True,
        "kernel_ms": median_ms(call),
        "direct_ms": median_ms(lambda: se_scale_ops.se_scale_cuda(x, gate)),
        **kernel_device_ms(call, "se_scale", se_scale_ops.KERNEL),
        "plain_ms": median_ms(lambda: se_scale_reference(x, gate)),
        "library_ms": median_ms(lambda: xm * gm),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(row)
    del x, xm
    torch.cuda.empty_cache()
    return row


def check_dwconv(dev, num_tta: int, n: int | None = None, path: str = "inference",
                 per_kernel: bool = False, h: int = 23, halo: int = 0) -> dict:
    """The depthwise conv at (n, 5, h, 40, 576) bf16, n = num_tta·CHUNK
    (the chunk program's) unless given; ``h`` a band's window rows on the
    spatial path, of which ``halo`` are a neighbour's: the bound counts the
    window read once and only the band's own h − halo rows written (the
    kernel's halo rows of output are cropped). ``per_kernel`` takes the
    device time by ``device_ms_events``."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n or num_tta * CHUNK, 5, h, 40, 576), generator=g,
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

    out_numel = x.numel() // h * (h - halo)
    nbytes = x.numel() * 2 + out_numel * 2 + 27 * 576 * 2
    bound_ms, bound_by = bound(nbytes, 54 * out_numel)
    row = {
        "name": "dwconv3d", "path": path, "tta": num_tta == 2, "shape": list(x.shape),
        "dtype": "bfloat16",
        "max_abs_diff": err, "tolerance": tol, "library_max_abs_diff": lib_err,
        "kernel_ms": median_ms(lambda: dwconv3d(x, k)),
        "direct_ms": median_ms(lambda: dw_ops._dwconv3d_cuda_route(x, k)),
        **({"device_ms": device_ms_events(lambda: dwconv3d(x, k), dw_ops.KERNEL),
            "device_ms_method": "cuda_events_behind_sleep"} if per_kernel else
           kernel_device_ms(lambda: dwconv3d(x, k), "dwconv3d_kernel", dw_ops.KERNEL)),
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
           **kernel_device_ms(kernel, "resample", warp_ops.KERNEL),
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


def flagship_video() -> np.ndarray:
    """The inference phase's synthetic video: 3 chunks of predictions."""
    num_frames = 3 * CHUNK + 30
    src = SyntheticSource(num_frames=num_frames, height=HEIGHT, width=WIDTH, seed=0,
                          events={100: 0, 200: 1, 300: 0})
    return np.stack([src.fetch_frame(i) for i in range(num_frames)])


def flagship(dev, card: str) -> tuple[dict, tuple, np.ndarray, np.ndarray, dict]:
    """The chunked inference phase; returns its launches, the seeded
    weights and synthetic video, which the serving and ensemble phases use
    again, the main path's predictions, and its fps (which phase 9 compares
    predicting from a store with)."""
    frames = flagship_video()
    num_frames = len(frames)
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
    return launches, weights, frames, raw_main, fps


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


def grad_ratios(grads: dict, ref: dict, floor: float) -> dict:
    """Per tensor, max|grad − ref| over max|ref|, floored at ``floor`` of
    the largest gradient of ``ref``; worst first."""
    top = max(g.abs().max().item() for g in ref.values())
    ratios = {n: ((grads[n] - g).abs().max().item() / max(g.abs().max().item(), floor * top))
              for n, g in ref.items()}
    return dict(sorted(ratios.items(), key=lambda kv: -kv[1]))


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
    ratios = grad_ratios(card_grads, cpu_grads, STEP_GRAD_FLOOR)
    worst = next(iter(ratios))
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
    """The kernels' counts since the last ``reset_counts``, the warp's by
    pass, GeM's band-partial launches and the SE scale's on planes apart."""
    return {**{k.name: k.launches for k in KERNELS},
            "warp_H": warp_ops.KERNEL.launches_by.get("H", 0),
            "warp_V": warp_ops.KERNEL.launches_by.get("V", 0),
            "gem_partial": gem_ops.KERNEL.launches_by.get(gem_ops.PARTIAL, 0),
            "se_scale_planes": se_scale_ops.KERNEL.launches_by.get(se_scale_ops.PLANES, 0)}


def counted(name: str, launches: dict, fn):
    """Run ``fn`` with the launch counters set to 0 just before; record its
    path's counts under ``name``."""
    for k in KERNELS:
        k.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches[name] = path_launches()
    return out


def write_recipe_game(game_dir: Path, label_file: str, events: dict, seed: int,
                      frames: int | None = None) -> None:
    """Two halves of ``frames`` (default ``RECIPE_FRAMES``) synthetic
    WIDTH×VIDEO_HEIGHT frames as gray stores (``<half>_720p.mkv.gray``, a
    bright square near each event) with their info sidecars, and the label
    file: ``events`` maps each half to {frame: (label, visibility or None)}."""
    frames = frames or RECIPE_FRAMES
    classes = sorted({label for half in events.values() for label, _ in half.values()})
    annotations = []
    for half, half_events in events.items():
        src = SyntheticSource(num_frames=frames, height=VIDEO_HEIGHT, width=WIDTH,
                              seed=seed + half,
                              events={f: classes.index(lab) for f, (lab, _) in half_events.items()})
        video = game_dir / f"{half}_720p.mkv"
        write_gray_store(Path(str(video) + ".gray"),
                         (src.fetch_frame(i) for i in range(frames)), VIDEO_HEIGHT,
                         WIDTH, frames)
        Path(str(video) + ".info.json").write_text(json.dumps(
            dict(frame_count=frames, fps=25.0, width=WIDTH, height=VIDEO_HEIGHT)))
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


def serving_frames(video: np.ndarray) -> np.ndarray:
    """One synthetic 720p video, the streaming engine's: the middle 720 rows
    of the inference phase's."""
    top = (video.shape[1] - VIDEO_HEIGHT) // 2
    return np.ascontiguousarray(video[:STREAM_FRAMES, top:top + VIDEO_HEIGHT])


def serving_videos(frames: np.ndarray) -> dict:
    """Four 96-frame segments of ``serving_frames``, one per live stream."""
    return {k: frames[k * SERVE_FRAMES:(k + 1) * SERVE_FRAMES] for k in range(SERVE_STREAMS)}


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
    frames = serving_frames(video)
    videos = serving_videos(frames)
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
                               for name in ("gem_pool", "dwconv3d", "warp_resample",
                                            "bias_act")},
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


def tiny_weights():
    """A small model (``TINY_ARCH``, two 3D blocks) with seeded weights and
    BN statistics calibrated on a 40-frame 64x96 video: (model, params,
    video)."""
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
    return model, params, video


def tiny_cpu_artifact(path: Path):
    """``tiny_weights``' checkpoint sealed by the export CLI on the CPU (the
    route the CLI always seals; float32, chunk 8, BN folded), its video,
    and the count of BNs the CLI folds."""
    model, params, video = tiny_weights()
    tree = state_dict_to_flax_tree(model.state_dict(), model)
    ckpt = path.with_suffix(".ckpt")
    save_checkpoint(ckpt, params, tree, tree)
    art = export_model.main(["--checkpoint", str(ckpt), "--output", str(path),
                             "--chunk_size", "8", "--dtype", "float32", "--device", "cpu"])
    return art, video, sum(isinstance(m, BatchNormAct) for m in model.modules())


def op_nodes(program) -> dict:
    """The count of each ``bas_torch`` op's nodes in an exported program."""
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    return {name: targets.count(f"bas_torch.{name}.default")
            for name in ("gem_pool", "dwconv3d", "warp_resample", "bias_act")}


def folded_bns(model) -> int:
    """``model``'s folded BNs: a sealed chunk program holds one
    ``bas_torch::bias_act`` node for each."""
    return sum(isinstance(m, BatchNormAct) and m.folded for m in model.modules())


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
        bns = folded_bns(live.model)
        if probe["op_nodes"] != {"gem_pool": 1, "dwconv3d": DW_PER_CHUNK, "warp_resample": 0,
                                 "bias_act": bns}:
            fail(f"the exported flagship program holds {probe['op_nodes']} custom-op nodes, "
                 f"expected {bns} bias_act nodes")
        launches["export"] = probe["launches"]
        expect_launches("export", probe["launches"], CHUNKS, CHUNKS * DW_PER_CHUNK)
        if probe["launches"]["bias_act"] != CHUNKS * bns:
            fail(f"the sealed program launched bias_act {probe['launches']['bias_act']} times, "
                 f"expected {CHUNKS} × {bns}")
        diff = agree("export_vs_live_frame_carry", raw_sealed, raw_live, PRED_BF16_ATOL)
        new = torch.from_numpy(frames[:CHUNK]).to(dev)
        carry = torch.from_numpy(frames[:live.overlap]).to(dev)
        live_ms = chunk_ms(live.chunk_frames, new, carry)

        art_cpu, video, tiny_bns = tiny_cpu_artifact(tmp / "tiny_cpu.bastorx")
        on_cpu = ExportedChunkPredictor(art_cpu, device="cpu")
        on_card = ExportedChunkPredictor(art_cpu, device=dev)
        cpu_traced_nodes = op_nodes(on_card.program)
        if cpu_traced_nodes != {"gem_pool": 1, "dwconv3d": 2, "warp_resample": 0,
                                "bias_act": tiny_bns}:
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


# --------------------------------------------------------------- phase 9 ---

STORE_FRAMES = 400    # per half: two ball games of two halves at WIDTH×VIDEO_HEIGHT
STORE_FOLDS = (0, 1)  # the folds whose games phase 9 writes; fold 0's is validated on
STORE_EVENTS = {half: {f: (ball.classes[k % 2], None)
                       for k, f in enumerate(range(40, STORE_FRAMES - 20, 40))}
                for half in (1, 2)}
STORE_EXPERIMENT = "store_train"
GATHER_BATCHES = (BATCH, 128)  # the flagship's train batch, and a large batch of clips
GATHER_THREADS = (1, 4, 8)
GATHER_REPS = 3
LOADER_STEPS = 16  # steps of each rep of the loader-share measurement
LOADER_REPS = 2
SMOOTH_FRAMES = 45 * 60 * 25   # a 45-minute half at 25 fps
SMOOTH_SHORT = 5               # a row shorter than the kernel's radius (12 at sigma 3)
SMOOTH_ATOL = 2e-3             # tests/test_core_postprocess.py's tolerance against scipy
TRACE_NAMES = ("gem_partial_kernel", "resample_")  # GeM's and the warp's kernels
# steps traced: the trace of a single step was seen to lack its first
# kernels (the warp's) on the card, as the start of a torch.profiler trace
# may, so the first step is the trace's warm-up
TRACE_STEPS = 2
PORT_CONFIGS = Path(__file__).resolve().parent / "ball_action_spotting_torch" / "configs"
REHEARSAL_PATHS = {  # (CLI module's last name, experiment, challenge) → launch path
    ("train", "sampling_weights_001", False): "rehearsal_stage1_train",
    ("action_train", "action_sampling_weights_002", False): "rehearsal_stage2_train",
    ("train", "ball_tuning_001", False): "rehearsal_stage3_train",
    ("train", "ball_finetune_long_004", False): "rehearsal_stage4_train",
    ("predict", "sampling_weights_001", False): "rehearsal_stage1_predict",
    ("predict", "ball_tuning_001", False): "rehearsal_stage3_predict",
    ("predict", "ball_finetune_long_004", False): "rehearsal_stage4_predict",
    ("predict", "ball_finetune_long_004", True): "rehearsal_challenge_predict",
}


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def store_games() -> list:
    """The games of ``STORE_FOLDS`` as gray stores of ``STORE_FRAMES`` frames
    a half, with labels and info sidecars, in the current workspace."""
    games = [ball.fold2games[fold][0] for fold in STORE_FOLDS]
    for i, game in enumerate(games):
        write_recipe_game(ball.DOMAIN.soccernet_dir / game, ball.DOMAIN.label_file, STORE_EVENTS,
                          seed=40 + 10 * i, frames=STORE_FRAMES)
    return games


def gather_readers(store: Path, card: str) -> dict:
    """Batches of the flagship's clips (random centers, the first and last
    frame among them, so indexes clamp at both ends) gathered from ``store``
    into padded slots of a batch buffer, as the loader fills them, by the
    native reader at each of ``GATHER_THREADS`` and by the numpy reader, in
    turns after one read warmed the page cache: clips/s and GB/s of each,
    and every native buffer bitwise the numpy one's."""
    ap = flagship_config()["argus_params"]
    gen = StackIndexesGenerator(ap["frame_stack_size"], ap["frame_stack_step"])
    readers = {"numpy": GrayStore(store, native=False),
               **{f"native_{t}": GrayStore(store, num_threads=t) for t in GATHER_THREADS}}
    n, h, w = readers["numpy"].frame_count, readers["numpy"].height, readers["numpy"].width
    readers["numpy"].read(0, n)  # page cache
    top = (HEIGHT - h) // 2
    rng = np.random.default_rng(9)
    rows = {}
    for batch in GATHER_BATCHES:
        centers = np.concatenate([[0, n - 1], rng.integers(0, n, batch - 2)])
        clips = np.stack([gen.make_stack_indexes(int(c)) for c in centers])
        reference = np.zeros((batch, len(clips[0]), HEIGHT, WIDTH), np.uint8)
        readers["numpy"].gather(clips, out=reference[:, :, top:top + h])
        buf = np.empty_like(reference)
        row = {"clips": batch, "clip_frames": len(clips[0]),
               "clamped_low": int((clips < 0).sum()), "clamped_high": int((clips >= n).sum())}
        for name, reader in readers.items():
            buf.fill(0)
            view = buf[:, :, top:top + h]
            ms = wall_ms(lambda: reader.gather(clips, out=view), reps=GATHER_REPS)
            if not np.array_equal(buf, reference):
                fail(f"gather {name} at {batch} clips differs from the numpy reader")
            row[name] = {"ms": ms, "clips_per_s": batch / ms * 1e3,
                         "gb_per_s": clips.size * h * w / ms / 1e6}
        if batch == GATHER_BATCHES[-1]:
            rows["loader_pattern"] = gather_like_loader(store, clips, reference, buf, top)
        del reference, buf
        rows[batch] = row
    for reader in readers.values():
        reader.close()
    log({"phase": "gather", "card": card, "store": store.name, "frame": [h, w],
         "padded_to": [HEIGHT, WIDTH], "bitwise_equal": True, "batches": rows})
    return rows


def gather_like_loader(store: Path, clips: np.ndarray, reference: np.ndarray, buf: np.ndarray,
                       top: int) -> dict:
    """``clips`` gathered as the loader asks for them: one clip per call into
    its padded slot, from ``num_decode_workers`` threads at once, each with a
    reader of its own (the loader's per-thread sources), by the native
    reader (which gathers a single clip on the calling thread) and by the
    numpy reader, in turns: clips/s and GB/s of each, bitwise equal."""
    workers = num_decode_workers(flagship_config())
    h = reference.shape[2] - 2 * top
    kinds = {"numpy": dict(native=False), "native": dict(native=True)}
    readers = {name: [GrayStore(store, **kw) for _ in range(workers)]
               for name, kw in kinds.items()}

    def run(pool, name):
        def worker(k):
            for i in range(k, len(clips), workers):
                readers[name][k].gather(clips[i:i + 1], out=buf[i:i + 1, :, top:top + h])
        t0 = time.perf_counter()
        list(pool.map(worker, range(workers)))
        return (time.perf_counter() - t0) * 1e3

    times = {name: [] for name in kinds}
    with ThreadPoolExecutor(workers) as pool:
        for name in kinds:  # warm-up, and each reader's output checked
            buf.fill(0)
            run(pool, name)
            if not np.array_equal(buf, reference):
                fail(f"gather {name} as the loader calls it differs from the numpy reader")
        for _ in range(GATHER_REPS):
            for name in kinds:
                times[name].append(run(pool, name))
    for group in readers.values():
        for reader in group:
            reader.close()
    row = {"workers": workers, "clips": len(clips), "clips_per_call": 1}
    for name, ms in times.items():
        ms = statistics.median(ms)
        row[name] = {"ms": ms, "clips_per_s": len(clips) / ms * 1e3,
                     "gb_per_s": clips.size * h * reference.shape[3] / ms / 1e6}
    return row


def loader_share(dev, trainer, config: dict, games: list, workers: int) -> tuple[dict, tuple]:
    """The loader's share of the fit loop: ``train_epoch`` over a loader of
    ``LOADER_STEPS`` steps against as many steps on one batch already on the
    card, each ``LOADER_REPS`` times in turns. The share is signed; it is
    resolved only where it is larger than the spread of either kind's reps.
    Returns the numbers and the batch on the card."""
    config = dict(config, train_epoch_size=BATCH * LOADER_STEPS)
    train_ds, _ = build_datasets(config, ball.DOMAIN, games[1:], games[:1], ball.game2fold)
    loader = ClipLoader(train_ds, BATCH, num_workers=workers)
    frames, targets = next(iter(loader.epoch(0)))
    batch = tuple(torch.from_numpy(np.array(x)).to(dev) for x in (frames, targets))

    def on_card():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LOADER_STEPS):
            aux = trainer.train_step(trainer.state, *batch, 3)
        float(aux["loss"])
        return (time.perf_counter() - t0) * 1e3 / LOADER_STEPS

    loaded, card = [], []
    for rep in range(LOADER_REPS):
        loaded.append(BATCH / trainer.train_epoch(loader, rep + 1)["train_samples_per_sec"] * 1e3)
        card.append(on_card())
    share = 1.0 - statistics.mean(card) / statistics.mean(loaded)
    spread = max((max(x) - min(x)) / statistics.mean(x) for x in (loaded, card))
    return {"loader_steps": LOADER_STEPS, "loader_reps": LOADER_REPS,
            "ms_per_step_with_loading": loaded,
            "ms_per_step_on_card": card, "loader_share": share, "spread": spread,
            "resolved": abs(share) > spread}, batch


def store_train(dev, games: list, launches: dict):
    """The flagship trainer through ``train/pipeline.py``'s datasets over the
    stores (native reader; validation through ``make_sequential_factory``,
    which passes a store through unwrapped), then the loader's share of the
    fit loop (``loader_share``)."""
    config = flagship_config()
    train_ds, val_ds = build_datasets(config, ball.DOMAIN, games[1:], games[:1], ball.game2fold)
    source = val_ds.source_factory(val_ds.videos_data[0])
    if type(source) is not GrayStoreSource or not source.store.native:
        fail(f"validation read a store through {type(source).__name__}, expected the native "
             "GrayStoreSource unwrapped")
    source.close()
    workers = num_decode_workers(config)
    train_loader = ClipLoader(train_ds, BATCH, num_workers=workers)
    val_loader = ClipLoader(val_ds, BATCH, num_workers=workers)
    save_dir = ball.DOMAIN.experiments_dir / STORE_EXPERIMENT / "fold_0"
    trainer = Trainer(config, list(ball.classes), save_dir, augment=AugmentConfig(),
                      mixup=make_mixup_fn(config.get("mixup_params")), device=dev)
    trainer.init_state()
    epochs, train_epoch = [], trainer.train_epoch

    def recording_epoch(loader, epoch):
        epochs.append(train_epoch(loader, epoch))
        return epochs[-1]

    trainer.train_epoch = recording_epoch
    best = counted(STORE_EXPERIMENT, launches, lambda: trainer.fit(train_loader, val_loader))
    del trainer.train_epoch  # the method again
    got = launches[STORE_EXPERIMENT]
    steps = sum(config["num_epochs"]) * -(-config["train_epoch_size"] // BATCH)
    losses = [e["train_loss"] for e in epochs] + [best.get("val_loss")]
    if trainer.state.step != steps or not all(x is not None and math.isfinite(x)
                                              for x in losses):
        fail(f"training from the stores: {trainer.state.step} steps (expected {steps}), "
             f"losses {losses}")
    if not (got["warp_H"] == got["warp_V"] == steps and got["gem"] >= steps):
        fail(f"training from the stores did not launch the warp per step and GeM: {got}")
    fit_steps = trainer.state.step
    share, batch = loader_share(dev, trainer, config, games, workers)
    log({"phase": "store_train", "steps": fit_steps, "losses": losses,
         "launches": got, "fit_samples_per_sec": [e["train_samples_per_sec"] for e in epochs],
         "workers": workers, "val_average_precision": best.get("val_average_precision"),
         **share})
    return trainer, batch


def store_predict(dev, game: str, fps_main: dict, launches: dict) -> None:
    """The ball predict CLI from the store-trained checkpoint over one game
    (TTA on): end-to-end fps against phase 1's device fps, and the same
    predictions as ``ChunkedVideoPredictor`` over the frames as an array."""
    argv = ["--experiment", STORE_EXPERIMENT, "--folds", "0", "--device", str(dev)]
    t0 = time.perf_counter()
    counted("store_predict", launches, lambda: ball_predict(argv))
    seconds = time.perf_counter() - t0
    got = launches["store_predict"]
    if not (got["gem"] > 0 and got["dwconv3d"] > 0):
        fail(f"predicting from a store did not launch GeM and dwconv3d: {got}")
    ckpt = get_best_checkpoint_path(ball.DOMAIN.experiments_dir / STORE_EXPERIMENT / "fold_0")
    predictor = ChunkedVideoPredictor(ckpt, device=dev, tta=True)
    pred_dir = ball.DOMAIN.predictions_dir / STORE_EXPERIMENT / "cv" / "fold_0" / game
    diffs, array_seconds = [], 0.0
    for half in ball.DOMAIN.halves:
        store = ball.DOMAIN.soccernet_dir / game / f"{half}_720p.mkv.gray"
        frames = GrayStore(store, native=False).read(0, STORE_FRAMES)
        idx, raw, secs = run_video(predictor, frames)
        array_seconds += secs
        cli_idx, cli_raw = load_raw_predictions(pred_dir / f"{half}_raw_predictions.npz")
        if not np.array_equal(np.asarray(idx), cli_idx):
            fail("the predict CLI's frame indexes differ from the array path's")
        diffs.append(agree(f"store_predict_cli_vs_array_half{half}", cli_raw, raw,
                           PRED_BF16_ATOL))
    frames_total = len(ball.DOMAIN.halves) * STORE_FRAMES
    log({"phase": "store_predict", "launches": got, "max_abs_diff": max(diffs),
         "cli_seconds": seconds, "cli_end_to_end_fps": frames_total / seconds,
         "array_end_to_end_fps": frames_total / array_seconds,
         "phase1_device_fps_tta_on": fps_main["device_fps_tta_on"],
         "phase1_end_to_end_fps_tta_on": fps_main["end_to_end_fps_tta_on"]})


def smoothing(dev, card: str) -> None:
    """``smooth_scores_batch`` on the device over a full half's two class
    curves and over rows shorter than the kernel's radius, against scipy."""
    sigma = ball.DOMAIN.postprocess.gauss_sigma
    rng = np.random.default_rng(12)
    rows = {}
    for name, length in (("full_half", SMOOTH_FRAMES), ("short_row", SMOOTH_SHORT)):
        scores = rng.random((2, length)).astype(np.float32)
        got = smooth_scores_batch(scores, sigma, device=dev)
        t0 = time.perf_counter()
        ref = gaussian_filter1d(scores.astype(np.float64), sigma, axis=-1)
        host_ms = (time.perf_counter() - t0) * 1e3
        diff = float(np.abs(got - ref).max())
        rows[name] = {"shape": list(scores.shape), "max_abs_diff": diff,
                      "ms": wall_ms(lambda: smooth_scores_batch(scores, sigma, device=dev), 5),
                      "scipy_host_ms": host_ms}
        if not (got.shape == scores.shape and diff <= SMOOTH_ATOL):
            fail(f"smoothing {name}: max|diff| {diff} > {SMOOTH_ATOL} against scipy")
    log({"phase": "smoothing", "card": card, "sigma": sigma, "atol": SMOOTH_ATOL, **rows})


def traced_step(trainer, batch, log_dir: Path) -> None:
    """``TRACE_STEPS`` train steps under ``device_trace``: the trace file
    must exist and name the GeM and warp kernels (the log counts the
    trace's events that name each)."""
    with profiling.device_trace(log_dir) as path:
        for _ in range(TRACE_STEPS):
            trainer.train_step(trainer.state, *batch, 4)
    events = json.loads(path.read_text())["traceEvents"] if path.exists() else []
    found = {name: sum(name in str(event.get("name", "")) for event in events)
             for name in TRACE_NAMES}
    log({"check": "device_trace", "file": path.name, "steps": TRACE_STEPS,
         "events": len(events), "events_naming": found})
    if not all(found.values()):
        fail(f"the device trace {path} does not name every kernel: {found}")


def stage_config(name: str, domain) -> dict:
    """A shipped stage config cut in depth as phase 5 cuts it."""
    return recipe_config(load_experiment_config(name, domain,
                                                configs_dir=PORT_CONFIGS / domain.name))


def rehearsal_workspace(root: Path, sources: list) -> None:
    """The rehearsal's workspace: every fold's and challenge game of the ball
    domain and an action game, their halves hard links to the stores of the
    game directories ``sources`` (in turn), the stage configs and the action
    splits."""
    targets = [(ball.DOMAIN.soccernet_dir / g, ball.DOMAIN.label_file, None)
               for g in ball.fold_games + ball.challenge_games]
    targets.append((action.DOMAIN.soccernet_dir / "synthetic/action_game",
                    action.DOMAIN.label_file, ACTION_EVENTS))
    for i, (game_dir, label_file, events) in enumerate(targets):
        source = sources[i % len(sources)]
        game_dir.mkdir(parents=True)
        for half in ball.DOMAIN.halves:
            for suffix in (".gray", ".info.json"):
                os.link(source / f"{half}_720p.mkv{suffix}", game_dir / f"{half}_720p.mkv{suffix}")
        if events is None:
            shutil.copy(source / ball.DOMAIN.label_file, game_dir / label_file)
        else:
            annotations = [{"gameTime": f"{half} - 00:{f // 25:02d}", "label": label,
                            "position": str(f * 40), "visibility": visibility}
                           for half, half_events in events.items()
                           for f, (label, visibility) in half_events.items()]
            (game_dir / label_file).write_text(json.dumps({"annotations": annotations}))
    for domain, names in ((ball.DOMAIN, ("sampling_weights_001", "ball_tuning_001",
                                         "ball_finetune_long_004")),
                          (action.DOMAIN, ("action_sampling_weights_002",))):
        (root / "configs" / domain.name).mkdir(parents=True)
        for name in names:
            (root / "configs" / domain.name / f"{name}.py").write_text(
                f"config = {stage_config(name, domain)!r}\n")
    (root / "splits").mkdir()
    for split in ("train", "val"):
        (root / "splits" / f"{split}.json").write_text(json.dumps(["synthetic/action_game"]))


def rehearsal_on_card(dev, root: Path, sources: list, launches: dict) -> None:
    """``cli/rehearsal.py`` in process on the card over phase 9's games,
    each stage cut in depth as phase 5 cuts it: the launches of every step,
    stage 4's losses (its first run on the card) and the cv ensemble's
    mAP. Stage 1 trains and predicts every fold, since stage 3 reads the
    out-of-fold predictions of each game it trains on."""
    steps = []
    args = rehearsal.parse_arguments(["--folds", "all", "--stage_folds", "0", "--in_process",
                                      "--device", str(dev)])
    with environ(BAS_TPU_WORKDIR=str(root), BAS_TPU_CONFIGS_DIR=str(root / "configs"),
                 BAS_TPU_ACTION_SPLITS=str(root / "splits")):
        rehearsal_workspace(root, sources)
        # the steps of ``rehearsal.main`` with ``--in_process``, each counted
        for module, argv in rehearsal.steps(args):
            t0 = time.perf_counter()
            counted("step", {}, lambda: rehearsal.run_in_process(module, argv))
            key = (module.rsplit(".", 1)[-1], argv[1], "--challenge" in argv)
            steps.append({"step": " ".join([key[0], *argv]), "launches": path_launches(),
                          "seconds": time.perf_counter() - t0})
            if key in REHEARSAL_PATHS:
                launches[REHEARSAL_PATHS[key]] = path_launches()
        with open(ball.DOMAIN.experiments_dir / "ball_finetune_long_004" / "fold_0"
                  / "log.csv") as f:
            stage4 = list(csv.DictReader(f))
        ens = ball.DOMAIN.predictions_dir / "ball_tuning_001,ball_finetune_long_004" / "cv" \
            / "fold_0" / "evaluate_results.json"
        ens_map = check_map("the rehearsal's cv ensemble", json.loads(ens.read_text()))
    losses = [float(row[k]) for row in stage4 for k in ("train_loss", "val_loss") if row.get(k)]
    log({"phase": "rehearsal", "steps": steps, "stage4_losses": losses,
         "cv_ensemble_a_mAP": ens_map})
    if len(losses) < 3 or not all(math.isfinite(x) for x in losses):
        fail(f"stage 4's losses are not all finite: {losses}")
    for path in REHEARSAL_PATHS.values():
        got = launches.get(path)
        if got is None:
            fail(f"the rehearsal ran no step of {path}")
        kernels = ("warp_H", "warp_V", "gem") if path.endswith("_train") else ("gem", "dwconv3d")
        if not all(got[k] > 0 for k in kernels):
            fail(f"{path} did not launch {kernels}: {got}")


def host_data_path(dev, card: str, fps_main: dict, work: Path) -> dict:
    """Phase 9: full-size gray stores, the native gather against numpy,
    training and predicting from the stores, on-device smoothing, a device
    trace and the rehearsal CLI, each stage a ``host_data.*`` span of the
    tracer (``utils/profiling.py``). Returns the launches of each path."""
    launches: dict = {}
    profiling.reset()
    profiling.enable()
    try:
        with environ(BAS_TPU_WORKDIR=str(work / "stores")):
            with profiling.span("host_data.write_stores"):
                games = store_games()
            stores = sorted(ball.DOMAIN.soccernet_dir.rglob("*.gray"))
            log({"phase": "store_write", "halves": len(stores), "frames_per_half": STORE_FRAMES,
                 "frame": [VIDEO_HEIGHT, WIDTH],
                 "store_gb": sum(p.stat().st_size for p in stores) / 1e9,
                 "seconds": profiling.records().named("host_data.write_stores")[0].ns / 1e9})
            with profiling.span("host_data.gather"):
                gather_readers(stores[0], card)
            with profiling.span("host_data.store_train"):
                trainer, batch = store_train(dev, games, launches)
            with profiling.span("host_data.device_trace"):
                traced_step(trainer, batch, work / "trace")
            del trainer, batch
            torch.cuda.empty_cache()
            with profiling.span("host_data.store_predict"):
                store_predict(dev, games[0], fps_main, launches)
            with profiling.span("host_data.smoothing"):
                smoothing(dev, card)
            sources = [ball.DOMAIN.soccernet_dir / game for game in games]
        torch.cuda.empty_cache()
        with profiling.span("host_data.rehearsal"):
            rehearsal_on_card(dev, work / "rehearsal", sources, launches)
    finally:
        profiling.disable()
    log({"phase": "host_data_stages",
         "stages": profiling.records().report("host_data.").splitlines()})
    return launches


# -------------------------------------------------------------- phase 10 ---

PP_MICRO = 2            # pipeline_parallel's n_micro: pp(2) against iter_size=2
PP_TRAINER_STEPS = 3
MP_TIMED_STEPS = 3      # timed steps of each layout, after one
TP_MIN_CHANNELS = 256   # JAX's default: the b0 encoder's and 3D blocks' widest convs
# pp against iter_size and tp against the replicated step run the same
# kernels on the same data under deterministic cuDNN: four calls on one and
# on four H100s read 0.0 for every prediction and gradient. Only pp's loss
# sums in another order (one mean over the concatenated microbatches, not
# the mean of their means): 7.2e-8 relative in each call, held at 1e-6.
MP_LOSS_RTOL = 1e-6
MP_EXACT = 0.0          # predictions, gradients, parameters, EMA, BN buffers
# MultiStreamPredictor(mesh=) against per-stream StreamingPredictor: the
# same weights over other bucket shapes; 1.2e-7 (2 x 1 grid, one H100) and
# 6.0e-8 (4 x 1, four) read, held at the CPU test's 1e-5
SERVE_MESH_ATOL = 1e-5
MP_DTYPE = torch.bfloat16
DRYRUN_DEVICE = "cuda"


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for steps that are compared: its
    bf16 grouped conv3d wgrad otherwise sums in a run-dependent order (a
    depthwise weight's gradient of two runs of one step differed by 7.0e-3
    of its max on the card)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def launches_on() -> dict:
    """Each kernel's launches by device since the last ``reset_counts``."""
    return {k.name: dict(k.launches_on) for k in KERNELS}


def sync_all(devices) -> None:
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def wall_step_ms(step, devices, warmup: int = 1) -> float:
    """Median ms of ``MP_TIMED_STEPS`` calls of ``step()`` by the host
    clock, every device synchronized before and after each (a pipelined
    step spans two cards)."""
    times = []
    for i in range(warmup + MP_TIMED_STEPS):
        sync_all(devices)
        t0 = time.perf_counter()
        step()
        sync_all(devices)
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mp_model(drop: bool = True, dtype: torch.dtype | None = None):
    """The flagship model (``flagship_config``'s kwargs; drop rates 0
    unless ``drop``), seeded weights, in ``dtype`` (default ``MP_DTYPE``),
    on the CPU."""
    name, kwargs = flagship_config()["argus_params"]["nn_module"]
    if not drop:
        kwargs = dict(kwargs, drop_rate=0.0, drop_path_rate=0.0)
    model = build_model(name, dtype=dtype or MP_DTYPE, **kwargs)
    init_train_weights(model, torch.Generator().manual_seed(0))
    return model


def flagship_loss():
    name, kwargs = flagship_config()["argus_params"]["loss"]
    return build_loss(name, **kwargs)


def mp_batch(dev, rows: int = BATCH, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (rows, TRAIN_FRAMES, HEIGHT, WIDTH),
                                           dtype=np.uint8)).to(dev)
    targets = torch.from_numpy((rng.random((rows, 2)) > 0.7).astype(np.float32)).to(dev)
    return frames, targets


def step_record(aux: dict, state) -> dict:
    """A train step's outcome on the CPU in float32, in the unsplit layout
    (``gathered``): the loss, the predictions, each gradient, and after the
    step the model's and the EMA's parameters and buffers."""
    return {"loss": float(aux["loss"]),
            "prediction": {"prediction": aux["prediction"].float().cpu()},
            "gradient": gathered({n: p.grad.float().cpu()
                                  for n, p in state.model.named_parameters()
                                  if p.grad is not None}),
            "model": gathered({n: t.float().cpu() for n, t in state.model.state_dict().items()}),
            "ema": gathered({n: t.float().cpu() for n, t in state.ema.state_dict().items()})}


def compare_steps(name: str, got: dict, ref: dict) -> dict:
    """Two ``step_record``s held to each other: the loss within
    ``MP_LOSS_RTOL``, every other tensor exactly (``MP_EXACT``)."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    row = {"check": name, "loss": got["loss"], "loss_ref": ref["loss"],
           "loss_rel_diff": loss_rel, "loss_rtol": MP_LOSS_RTOL, "tensor_atol": MP_EXACT}
    bad = [] if loss_rel <= MP_LOSS_RTOL else [f"loss {loss_rel}"]
    for part in ("prediction", "gradient", "model", "ema"):
        if got[part].keys() != ref[part].keys():
            fail(f"{name}: the {part} tensors differ in names")
        diffs = {n: (got[part][n] - t).abs().max().item() for n, t in ref[part].items()}
        worst = max(diffs, key=diffs.get)
        row[f"{part}_max_abs_diff"], row[f"{part}_worst"] = diffs[worst], worst
        row[f"{part}_tensors"] = len(diffs)
        if diffs[worst] > MP_EXACT:
            bad.append(f"{part} {worst} {diffs[worst]}")
    log(row)
    if bad:
        fail(f"{name}: {', '.join(bad)}")
    return row


def intersection_us(a: list, b: list) -> float:
    """The length of the intersection of two unions of intervals:
    |A| + |B| - |A ∪ B|."""
    return union_us(a) + union_us(b) - union_us(a + b)


def pp_overlap(step, devices: list) -> dict | None:
    """One pipelined step under torch.profiler: each stage card's busy ms
    (the union of its kernels' intervals) and the ms both were busy at
    once, with its share of the step's wall time. None where both stages
    are one card."""
    from torch.profiler import ProfilerActivity, profile

    if devices[0] == devices[1]:
        return None
    step()  # warm
    for d in devices:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        for d in devices:
            torch.cuda.synchronize(d)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {d.index: [] for d in devices}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_index in spans:
            spans[e.device_index].append((e.time_range.start, e.time_range.end))
    both_ms = intersection_us(*spans.values()) / 1e3
    return {"wall_ms": wall_ms,
            "busy_ms": {f"cuda:{i}": union_us(v) / 1e3 for i, v in spans.items()},
            "both_busy_ms": both_ms, "both_busy_share": both_ms / wall_ms}


def pp_vs_iter_size(dev, devices: list, card: str, launches: dict) -> dict:
    """One pipelined step (n_micro 2) on a (1, 2) grid against the
    ``iter_size`` = 2 step on one device, from the same weights and batch,
    augmentation and mixup on, drop rates 0, cuDNN deterministic: the
    outcomes of ``step_record`` (the stages' weights on their two cards,
    AdamW's step and the EMA over them included); then ms
    per step of each and of the flagship's plain step on one device, and
    where the stages are two cards the share of a step both are busy."""
    loss_fn = flagship_loss()
    aug, mix = AugmentConfig(), Mixup()
    schedule = lambda count: 1e-4  # noqa: E731
    model = mp_model(drop=False)
    mesh = make_mesh(1, 2, devices)
    pp_model = place_stages(copy.deepcopy(model), devices)
    pp_state = TrainState(pp_model, build_optimizer("AdamW", {}, pp_model))
    ref_model = copy.deepcopy(model).to(dev)
    ref_state = TrainState(ref_model, build_optimizer("AdamW", {}, ref_model))
    pp_step = make_pp_train_step(loss_fn, schedule, 0.999, mesh, PP_MICRO, augment=aug,
                                 mixup=mix)
    ref_step = make_train_step(loss_fn, schedule, 0.999, augment=aug, mixup=mix,
                               iter_size=PP_MICRO)
    frames, targets = mp_batch(dev)
    with deterministic_cudnn():
        aux = counted("pp_step", launches, lambda: pp_step(pp_state, frames, targets, 7))
        on = launches_on()
        got = step_record(aux, pp_state)
        ref = step_record(ref_step(ref_state, frames, targets, 7), ref_state)
    row = compare_steps("pp_vs_iter_size", got, ref)
    stage0, stage1 = (str(d) for d in devices)
    # the augmentation runs per microbatch: an H and a V pass each
    if on["warp"].get(stage0, 0) != 2 * PP_MICRO or on["gem"].get(stage1, 0) < 1:
        fail(f"the pipelined step did not launch the warp on {stage0} and GeM on {stage1}: {on}")
    row["launches_on"] = on
    row["ms_per_step_pp"] = wall_step_ms(lambda: pp_step(pp_state, frames, targets, 7), devices)
    row["pp_overlap"] = pp_overlap(lambda: pp_step(pp_state, frames, targets, 7), devices)
    row["ms_per_step_iter_size"] = wall_step_ms(
        lambda: ref_step(ref_state, frames, targets, 7), [dev])
    del pp_state, ref_state
    gc.collect()
    torch.cuda.empty_cache()
    one_model = mp_model().to(dev)
    one = TrainState(one_model, build_optimizer("AdamW", {}, one_model))
    one_step = make_train_step(loss_fn, schedule, 0.999, augment=aug, mixup=mix)
    row["ms_per_step_one_device"] = wall_step_ms(lambda: one_step(one, frames, targets, 7),
                                                 [dev])
    log({"phase": "pp_step", "card": card, "stage_devices": [str(d) for d in devices],
         **{k: row[k] for k in ("launches_on", "ms_per_step_pp", "ms_per_step_iter_size",
                                "ms_per_step_one_device", "pp_overlap")}})
    return row


def pp_trainer(dev, devices: list, launches: dict) -> dict:
    """``Trainer.fit`` through ``config["pipeline_parallel"]`` on a (1, 2)
    grid (augmentation on): a warmup and a train epoch of
    ``PP_TRAINER_STEPS`` steps each, validation on the split EMA, whose
    logits come back to stage 0's card beside the targets, and the epoch's
    ``.ckpt``, which must be byte for byte the one of the same weights in
    an unsplit model; the warp's launches on stage 0's card, GeM's on stage
    1's; then a prediction from the split EMA."""
    config = dict(flagship_config(), pipeline_parallel=PP_MICRO)
    epochs = sum(config["num_epochs"])
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, list(ball.classes), Path(tmp), augment=AugmentConfig(),
                          compute_dtype=MP_DTYPE, mesh=make_mesh(1, 2, devices))
        trainer.init_state()
        batches = [tuple(t.cpu().numpy() for t in mp_batch(dev, seed=s))
                   for s in range(PP_TRAINER_STEPS)]
        val_batches = [tuple(t.cpu().numpy() for t in mp_batch(dev, seed=PP_TRAINER_STEPS))]
        losses, step = [], trainer.train_step

        def recording_step(*args):
            aux = step(*args)
            losses.append(float(aux["loss"]))
            return aux

        trainer.train_step = recording_step
        best = counted("pp_train", launches,
                       lambda: trainer.fit(BatchList(batches), BatchList(val_batches),
                                           resume=False))
        on = launches_on()
        preds = trainer.predict_step(trainer.state, torch.from_numpy(batches[0][0]).to(dev))
        saved = sorted(Path(tmp).glob("*.ckpt"))
        nn_name, nn_kwargs = config["argus_params"]["nn_module"]
        plain, plain_ema = (build_model(nn_name, dtype=MP_DTYPE, **nn_kwargs) for _ in range(2))
        plain.load_state_dict(trainer.state.model.state_dict())
        plain_ema.load_state_dict(trainer.state.ema.state_dict())
        unsplit = Path(tmp) / "unsplit.bin"
        save_checkpoint(unsplit, trainer._params_dict(),
                        state_dict_to_flax_tree(plain_ema.state_dict(), plain_ema),
                        state_dict_to_flax_tree(plain.state_dict(), plain))
        same_ckpt = len(saved) == 1 and saved[0].read_bytes() == unsplit.read_bytes()
    stage0, stage1 = (str(d) for d in devices)
    row = {"check": "pp_trainer", "steps": len(losses), "losses": losses,
           "val_loss": best.get("val_loss"), "ckpts": [p.name for p in saved],
           "ckpt_is_unsplit_layout": same_ckpt, "launches": launches["pp_train"],
           "launches_on": on, "prediction_shape": list(preds.shape)}
    log(row)
    steps = epochs * PP_TRAINER_STEPS
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"pipeline_parallel Trainer steps: {losses}")
    if not math.isfinite(best.get("val_loss", math.nan)):
        fail(f"pipeline_parallel Trainer validation: {best}")
    if not same_ckpt:
        fail(f"the split model's checkpoints {saved} are not the unsplit model's layout")
    if on["warp"].get(stage0, 0) != 2 * PP_MICRO * steps or on["gem"].get(stage1, 0) < steps:
        fail(f"the pipelined Trainer steps did not launch the warp on {stage0} and GeM on "
             f"{stage1} on every step: {on}")
    if tuple(preds.shape) != (BATCH, 2) or not bool(torch.isfinite(preds).all()):
        fail(f"the split model's prediction: {tuple(preds.shape)}")
    return row


def tp_vs_replicated(dev, devices: list) -> dict:
    """A train step over a state split by ``shard_state`` on a (1, 2) grid
    against the same step replicated (augmentation and mixup on, drop rates
    0, cuDNN deterministic): the outcomes of ``step_record`` (AdamW's step
    and the EMA over the slices on the model-axis cards included), and the
    state's bytes on each model-axis index; ms per step."""
    loss_fn = flagship_loss()
    step = make_train_step(loss_fn, lambda count: 1e-4, 0.999, augment=AugmentConfig(),
                           mixup=Mixup())
    model = mp_model(drop=False).to(dev)
    ref = TrainState(model, build_optimizer("AdamW", {}, model))
    frames, targets = mp_batch(dev, seed=3)
    step(ref, frames, targets, 1)  # the moments exist before the split
    set_dropout_generator(ref.model, None)  # a generator cannot be copied
    tp = shard_state(copy.deepcopy(ref), make_mesh(1, 2, devices), TP_MIN_CHANNELS, row=0)

    def state_bytes(state) -> dict:
        """Bytes of parameters, EMA and moments by model-axis index."""
        out: dict = {}
        pairs = zip(state.model.named_parameters(), state.ema.parameters())
        for (name, p), e in pairs:
            index = int(name.rpartition(".")[2]) if SHARDS + "." in name else 0
            moments = sum(v.numel() * v.element_size()
                          for v in state.optimizer.state.get(p, {}).values()
                          if torch.is_tensor(v) and v.dim())
            out[index] = out.get(index, 0) + p.numel() * p.element_size() \
                + e.numel() * e.element_size() + moments
        return out

    with deterministic_cudnn():
        got = step_record(step(tp, frames, targets, 2), tp)
        ref_got = step_record(step(ref, frames, targets, 2), ref)
    row = compare_steps("tp_vs_replicated", got, ref_got)
    row["state_bytes_by_model_index"] = {
        f"{i} ({devices[i]})": b for i, b in sorted(state_bytes(tp).items())}
    row["state_bytes_replicated"] = sum(state_bytes(ref).values())
    row["split_leaves"] = sum(name.endswith(SHARDS + ".0")
                              for name, _ in tp.model.named_parameters())
    row["ms_per_step_tp"] = wall_step_ms(lambda: step(tp, frames, targets, 2), devices)
    log({"check": "tp_state_bytes", "by_model_index": row["state_bytes_by_model_index"],
         "replicated": row["state_bytes_replicated"], "split_leaves": row["split_leaves"]})
    return row


def serving_mesh(dev, weights, videos: dict, card: str, launches: dict) -> dict:
    """``MultiStreamPredictor(mesh=)`` on an N × 1 grid of the visible cards
    (the one card twice) against a ``StreamingPredictor`` per stream on the
    serving feed; GeM and dwconv3d launched on every data-axis card; ms per
    steady-state tick by bucket."""
    devices = parallel_devices(dev)
    events = serving_feed()
    kw = dict(weights=weights, tta=True)
    streaming = StreamingPredictor(device=dev, **kw)
    per_stream = {}
    for k, frames in videos.items():
        idx, raw = get_raw_predictions(streaming, FramesSource(frames), SERVE_FRAMES)
        per_stream[k] = dict(zip(idx, raw))
    del streaming
    predictor = MultiStreamPredictor(mesh=make_mesh(len(devices), 1, devices), **kw)
    warmed = warm_engine(predictor, SERVE_STREAMS, SERVE_MAX_BATCH)
    run = counted("serve_mesh", launches, lambda: serve_direct(predictor, videos, events))
    on = launches_on()
    expected = {key: n - SERVE_WINDOW + 1 for key, n in fed_per_life(events).items()}
    counts = {key: len(v) for key, v in run.items()}
    if counts != expected:
        fail(f"serve_mesh: predictions per stream life {counts}, expected {expected}")
    diff = compare_runs("serve_mesh_vs_per_stream", run,
                        {key: per_stream[key[0]] for key in expected}, SERVE_MESH_ATOL,
                        same_keys=False)
    for d in dict.fromkeys(str(d) for d in devices):
        if on["gem"].get(d, 0) < 1 or on["dwconv3d"].get(d, 0) < 1:
            fail(f"serve_mesh did not launch GeM and dwconv3d on {d}: {on}")
    buckets = sorted({predictor._bucket_shape(b) for b in TICK_BUCKETS})
    tick_ms = {b: device_tick_ms(predictor, b, reps=2)[0] for b in buckets}
    row = {"phase": "serve_mesh", "card": card, "grid": f"{len(devices)}x1",
           "grid_devices": [str(d) for d in devices], "warmed_buckets": warmed,
           "max_abs_diff": diff, "atol": SERVE_MESH_ATOL, "launches": launches["serve_mesh"], "launches_on": on,
           "tick_ms_by_bucket": tick_ms, "budget_ms": REALTIME_MS}
    log(row)
    return row


def model_parallel(dev, card: str, weights, video: np.ndarray) -> dict:
    """Phase 10: pipeline and tensor parallelism at the flagship's width on
    a (1, 2) grid of two cards (the one card twice), the serving mesh, and
    the dryrun over the visible cards; returns each path's launches."""
    launches: dict = {}
    devices = parallel_devices(dev)[:2]  # a (1, 2) grid: two cards, or the one twice
    steps = {}

    def step(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        steps[name] = time.perf_counter() - start
        return out

    pp = step("pp_vs_iter_size", pp_vs_iter_size, dev, devices, card, launches)
    step("pp_trainer", pp_trainer, dev, devices, launches)
    tp = step("tp_vs_replicated", tp_vs_replicated, dev, devices)
    serve = step("serving_mesh", serving_mesh, dev, weights,
                 serving_videos(serving_frames(video)), card, launches)
    dryrun = step("dryrun", dryrun_multichip, max(1, torch.cuda.device_count()),
                  DRYRUN_DEVICE)
    if not all(leg["ok"] for leg in dryrun):
        fail(f"the dryrun's legs: {dryrun}")
    log({"phase": "model_parallel", "card": card, "grid_devices": [str(d) for d in devices],
         "ms_per_step": {"pp": pp["ms_per_step_pp"], "iter_size": pp["ms_per_step_iter_size"],
                         "tp": tp["ms_per_step_tp"], "one_device": pp["ms_per_step_one_device"]},
         "tick_ms_by_bucket_mesh": serve["tick_ms_by_bucket"],
         "dryrun": dryrun, "seconds_by_step": steps})
    return launches


# -------------------------------------------------------------- phase 11 ---

SP_GEM_ROWS = (12, 11)     # the inference head's 23 rows over two bands
SP_DW_ROWS = (13, 12)      # a band's rows and its one halo row (band 1 of 2: 11 + 1)
SP_DW_HALO = 1             # window rows a band of two reads but does not write
SP_F32_FRAMES = 46         # the float32 check's short video, chunk 8, as phase 3's
SP_FPS_CHUNKS = 3          # chunk programs timed for device fps
# The banded float32 step against the unbanded one runs the same ops on
# windows of the same rows under deterministic cuDNN, TF32 off; the sums
# over bands and the convs of window shapes reorder float32 sums. The loss
# is held at the CPU tests' rel 1e-5 (tests/test_torch_spatial.py). A
# gradient at full width sums far more products than the CPU tests' tiny
# arch: the stem block's weight gradient sums 20 × 368 × 640 positions,
# which the bands split in two and cuDNN adds in its own order (3.0e-4 of
# that tensor's max on an H100 80GB HBM3 at 700 W, every other tensor
# below), so gradients are held at STEP_GRAD_TOL, 1e-3 of each tensor's
# max, as the card-vs-CPU float32 step. A BN bias followed by another
# batch-statistic BN has a gradient of 0 up to float32 rounding noise
# (6.8e-8 of the model's largest gradient on the CPU rehearsal), so each
# tensor's max is floored at STEP_GRAD_FLOOR of the largest, as there.
SP_STEP_LOSS_RTOL = 1e-5
SP_STEP_GRAD_TOL = STEP_GRAD_TOL


def sp_grids(dev) -> list:
    """[(n_data, n_model, devices)]: on one card (1, 2) and (1, 4) over it
    repeated; on n cards (1, n) and, where n ≥ 4, (2, n/2)."""
    n = torch.cuda.device_count()
    if n <= 1:
        return [(1, 2, [dev] * 2), (1, 4, [dev] * 4)]
    cards = [torch.device("cuda", i) for i in range(n)]
    return [(1, n, cards)] + ([(2, n // 2, cards)] if n >= 4 else [])


def check_gem_partial(dev, rows: int) -> dict:
    """GeM's band-partial launch at a band of the TTA-on inference head,
    (2·CHUNK·5, rows, 40, 256) bf16, against ``gem_pool_partial_reference``;
    two runs bit-identical."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2 * CHUNK * 5, rows, 40, 256), generator=g, device=dev).to(torch.bfloat16)
    p = torch.tensor([3.0], device=dev)
    before = gem_ops.KERNEL.launches_by.get(gem_ops.PARTIAL, 0)
    out = gem_pool_partial(x, p)
    per_call = gem_ops.KERNEL.launches_by.get(gem_ops.PARTIAL, 0) - before
    ref = gem_pool_partial_reference(x, p)
    err = (out - ref).abs().max().item()
    tol = GEM_TOL * ref.abs().max().item()
    if per_call < 1 or not err <= tol:
        fail(f"gem partial vs plain ({tuple(x.shape)}): {per_call} launches, max|diff| {err} "
             f"> {tol}")
    if not torch.equal(gem_pool_partial(x, p), out):
        fail(f"gem partial ({tuple(x.shape)}): two runs on one input differ")
    nbytes = x.numel() * 2 + out.numel() * 4 + 4
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())  # clamp, log, mul, exp (+ add)
    row = {
        "name": "gem_pool_partial", "path": "spatial inference, a band", "shape": list(x.shape),
        "dtype": "bfloat16", "max_abs_diff": err, "tolerance": tol,
        "launches_per_call": per_call,
        "kernel_ms": median_ms(lambda: gem_pool_partial(x, p)),
        "direct_ms": median_ms(lambda: gem_ops.gem_pool_partial_cuda(x, p)),
        **kernel_device_ms(lambda: gem_pool_partial(x, p), "gem_", gem_ops.KERNEL,
                           per_call=per_call),
        "plain_ms": median_ms(lambda: gem_pool_partial_reference(x, p)),
        "library_ms": median_ms(lambda: x.float().clamp_min(1e-6).pow(p).sum((1, 2))),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(row)
    return row


def sp_kernel_checks(dev) -> dict:
    """Phase 11's kernel rows: GeM's band-partial launch at the two bands
    of the head, and the depthwise kernel on the two bands' windows, each
    against its plain version."""
    rows = {f"gem_pool_partial_{h}rows": check_gem_partial(dev, h) for h in SP_GEM_ROWS}
    for h in SP_DW_ROWS:
        rows[f"dwconv3d_band_{h}rows"] = check_dwconv(dev, 2, path="spatial inference, a band",
                                                      h=h, halo=SP_DW_HALO)
    torch.cuda.empty_cache()
    return rows


def sp_device_fps(predictor, frames: np.ndarray, devices) -> tuple[float, dict]:
    """Chunk programs on frames already on the card(s): chunk frames per
    second, and the halo traffic of one chunk (``parallel/spatial.py::
    COUNTS``, counted from the windows' shapes)."""
    call = predictor.chunk_call()
    with torch.inference_mode():
        new = predictor.put_new(frames[:CHUNK])
        _, carry = call(new, predictor.init_carry(frames[:predictor.overlap]))
        sync_all(devices)
        SP_COUNTS.reset()
        t0 = time.perf_counter()
        for _ in range(SP_FPS_CHUNKS):
            _, carry = call(new, carry)
        sync_all(devices)
        secs = time.perf_counter() - t0
    halo = {"halo_bytes_per_chunk": SP_COUNTS.halo_bytes // SP_FPS_CHUNKS,
            "halo_copies_per_chunk": SP_COUNTS.halo_copies // SP_FPS_CHUNKS,
            "band_sums_per_chunk": SP_COUNTS.band_sums // SP_FPS_CHUNKS}
    return SP_FPS_CHUNKS * CHUNK / secs, halo


def sp_profile(predictor, frames: np.ndarray, devices) -> dict:
    """Two chunk programs on frames already on the card(s) under
    torch.profiler: wall ms a chunk, each card's busy ms (the union of its
    kernels' intervals) and idle share, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    call, reps = predictor.chunk_call(), 2
    with torch.inference_mode():
        new = predictor.put_new(frames[:CHUNK])
        _, carry = call(new, predictor.init_carry(frames[:predictor.overlap]))
        sync_all(devices)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                _, carry = call(new, carry)
            sync_all(devices)
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    _, summed_ms, top = device_time(prof, reps, 120, 8)
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(f"cuda:{e.device_index}", []).append(
                (e.time_range.start, e.time_range.end))
    busy = {d: union_us(v) / 1e3 / reps for d, v in sorted(spans.items())}
    return {"wall_ms_per_chunk": wall_ms, "busy_ms_per_chunk": busy,
            "idle_share": {d: max(0.0, 1.0 - b / wall_ms) for d, b in busy.items()},
            "kernel_sum_ms_per_chunk": summed_ms, "top": top}


def sp_inference(dev, card: str, weights, frames: np.ndarray, launches: dict) -> dict:
    """``ChunkedVideoPredictor(mesh=, spatial=True)`` on each of ``sp_grids``
    over the 414-frame video, TTA off and on, each run with the launch
    counters set to 0 and held against the unsplit frame-carry engine
    within ``PRED_BF16_ATOL``: end-to-end and device fps, band rows, halo
    traffic and launches per band device; then a float32 run on the first
    grid's (1, 2) against the unsplit engine within ``PRED_F32_ATOL``."""
    expected = len(frames) - 30
    unsplit, out = {}, {"card": card, "unsplit": {}, "grids": []}
    for tta in (False, True):
        engine = ChunkedVideoPredictor(weights=weights, device=dev, chunk_size=CHUNK, tta=tta,
                                       carry_features=False)
        run_video(engine, frames[:CHUNK + 30])  # warm-up: cuDNN plans
        _, unsplit[tta], secs = run_video(engine, frames)
        fps, _ = sp_device_fps(engine, frames, [dev])
        out["unsplit"][f"tta_{'on' if tta else 'off'}"] = {
            "end_to_end_fps": expected / secs, "device_fps": fps}
        if not tta:
            out["unsplit"]["profile_tta_off"] = sp_profile(engine, frames, [dev])
        del engine
    log({"phase": "sp_unsplit_frame_carry", "card": card, **out["unsplit"]})
    grids = sp_grids(dev)
    for n_data, n_model, devices in grids:
        mesh = make_mesh(n_data, n_model, devices)
        grid = {"grid": f"{n_data}x{n_model}", "devices": [str(d) for d in devices],
                "band_rows_input": list(spatial_bands(mesh, HEIGHT)[1]),
                "band_rows_at_1/32": list(spatial_bands(mesh, HEIGHT // 32)[1])}
        for tta in (False, True):
            engine = ChunkedVideoPredictor(weights=weights, chunk_size=CHUNK, mesh=mesh,
                                           spatial=True, tta=tta)
            run_video(engine, frames[:CHUNK + 30])
            name = f"sp_{n_data}x{n_model}_tta_{'on' if tta else 'off'}"
            idx, raw, secs = counted(name, launches, lambda: run_video(engine, frames))
            on = launches_on()
            check_outputs(name, idx, raw, expected)
            diff = agree(f"{name}_vs_unsplit", raw, unsplit[tta], PRED_BF16_ATOL)
            counts = launches[name]
            if counts["gem_partial"] < 1 or counts["dwconv3d"] < 1 or any(
                    on["gem"].get(str(d), 0) < 1 or on["dwconv3d"].get(str(d), 0) < 1
                    for d in devices):
                fail(f"{name} did not launch GeM's partial and dwconv3d on every band device: "
                     f"{counts} {on}")
            fps, halo = sp_device_fps(engine, frames, devices)
            grid[f"tta_{'on' if tta else 'off'}"] = {
                "max_abs_diff_vs_unsplit": diff, "end_to_end_fps": expected / secs,
                "device_fps": fps, **halo, "launches": counts, "launches_on": on}
            if not tta:
                grid["profile_tta_off"] = sp_profile(engine, frames, devices)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        out["grids"].append(grid)
        log({"phase": "sp_grid", "card": card, **grid})
    # the main path: the first grid, TTA on
    launches["sp_predict"] = launches[f"sp_{grids[0][0]}x{grids[0][1]}_tta_on"]

    f32 = dict(weights=weights, chunk_size=8, dtype=torch.float32, dw3d_use_kernel=True)
    short = frames[:SP_F32_FRAMES]
    _, raw32, _ = run_video(ChunkedVideoPredictor(device=dev, carry_features=False, **f32), short)
    grid = grids[0][2][:2]
    _, sp32, _ = run_video(ChunkedVideoPredictor(mesh=make_mesh(1, 2, grid), spatial=True,
                                                 **f32), short)
    out["f32_max_abs_diff"] = agree("sp_f32_1x2_vs_unsplit", sp32, raw32, PRED_F32_ATOL)
    return out


def sp_train_step(dev, card: str, launches: dict) -> dict:
    """The flagship stage-1 step (batch 4, no augmentation, as the dryrun's
    dp × sp leg) on bands over a (1, 2) grid (two cards, or the one twice)
    against the unbanded step from the same weights and batch, in float32
    under deterministic cuDNN: loss, predictions and every gradient. The
    banded step is the spatial training path: its launches go to
    ``launches["sp_train"]``, and GeM's band-partial launch must have run on
    every band device. Then ms a step of each in ``MP_DTYPE``."""
    devices = sp_grids(dev)[0][2][:2]
    mesh = make_mesh(1, 2, devices)
    loss_fn = flagship_loss()
    step = make_train_step(loss_fn, lambda count: 1e-4, 0.999)
    frames, targets = mp_batch(dev, seed=5)

    def banded_x() -> Bands:
        return bands_of(frames, *spatial_bands(mesh, frames.shape[2]), axis=2)

    records, on = [], {}
    with deterministic_cudnn():
        for banded in (False, True):
            model = mp_model(dtype=torch.float32).to(dev)
            state = TrainState(model, build_optimizer("AdamW", {}, model))
            if banded:
                aux = counted("sp_train", launches,
                              lambda: step(state, banded_x(), targets, 11))
                on = launches_on()
            else:
                aux = step(state, frames, targets, 11)
            records.append((float(aux["loss"]), aux["prediction"].float().cpu(),
                            {n: p.grad.float().cpu() for n, p in model.named_parameters()}))
            del model, state, aux
            gc.collect()
            torch.cuda.empty_cache()
    if launches["sp_train"]["gem_partial"] < 1 or any(
            on["gem"].get(str(d), 0) < 1 for d in devices):
        fail(f"the banded step did not launch GeM's partial on every band device: "
             f"{launches['sp_train']} {on}")
    (ref_loss, ref_pred, ref_grads), (loss, pred, grads) = records
    rel = abs(loss - ref_loss) / abs(ref_loss)
    ratios = grad_ratios(grads, ref_grads, STEP_GRAD_FLOOR)
    worst = next(iter(ratios))
    coarse = grad_ratios(grads, ref_grads, 1e-2)
    top = max(g.abs().max().item() for g in ref_grads.values())
    row = {"check": "sp_step_vs_unbanded", "card": card, "dtype": "float32",
           "devices": [str(d) for d in devices], "loss": loss, "loss_ref": ref_loss,
           "loss_rel_diff": rel, "loss_rtol": SP_STEP_LOSS_RTOL,
           "prediction_max_abs_diff": (pred - ref_pred).abs().max().item(),
           "grad_floor": STEP_GRAD_FLOOR,
           "worst_grad_diff_over_max": ratios[worst], "worst_grad": worst,
           "next_worst_grads": list(ratios.items())[1:5],
           "grads_floored": sorted(n for n, g in ref_grads.items()
                                   if g.abs().max().item() < STEP_GRAD_FLOOR * top),
           "worst_at_floor_1e-2": next(iter(coarse.items())),
           "grad_tol": SP_STEP_GRAD_TOL, "grad_tensors": len(ratios),
           "launches": launches["sp_train"], "launches_on": on}
    log(row)
    if not (rel <= SP_STEP_LOSS_RTOL and ratios[worst] <= SP_STEP_GRAD_TOL):
        fail(f"the banded float32 step disagrees with the unbanded one: loss {rel}, "
             f"grad {worst} {ratios[worst]}")

    for banded in (False, True):
        model = mp_model().to(dev)
        state = TrainState(model, build_optimizer("AdamW", {}, model))
        row[f"ms_per_step_{'banded' if banded else 'unbanded'}"] = wall_step_ms(
            lambda: step(state, banded_x() if banded else frames,
                         targets, 11), devices)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    log({"phase": "sp_step_ms", "card": card, "dtype": str(MP_DTYPE),
         "ms_per_step_unbanded": row["ms_per_step_unbanded"],
         "ms_per_step_banded": row["ms_per_step_banded"]})
    return row


def spatial(dev, card: str, weights, video: np.ndarray) -> tuple[dict, dict]:
    """Phase 11: spatial partitioning at the flagship's width: the kernel
    rows of the band shapes, the spatial engine on every grid against the
    unsplit one, the banded train step; returns each path's launches and
    the kernel rows."""
    t0 = time.perf_counter()
    launches: dict = {}
    rows = sp_kernel_checks(dev)
    inference = sp_inference(dev, card, weights, video, launches)
    train = sp_train_step(dev, card, launches)
    log({"phase": "spatial", "card": card, "inference": inference,
         "ms_per_step": {k: train[k] for k in ("ms_per_step_unbanded", "ms_per_step_banded")},
         "seconds": time.perf_counter() - t0})
    return launches, rows


# -------------------------------------------------------------- phase 12 ---

INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
# The flagship's five k×k int8 convs at a TTA-on chunk of feature carry
# (2·CHUNK stacks): (N, H, W, C_in, C_out, k, stride) of each conv's input.
INT8_SHAPES = {
    "int8_conv_blocks_0_0": (2 * CHUNK, 368, 640, 32, 16, 3, 1),
    "int8_conv_blocks_1_0": (2 * CHUNK, 368, 640, 16, 64, 3, 2),
    "int8_conv_blocks_1_1": (2 * CHUNK, 184, 320, 32, 128, 3, 1),
    "int8_conv_blocks_2_0": (2 * CHUNK, 184, 320, 32, 128, 3, 2),
    "int8_conv_blocks_2_1": (2 * CHUNK, 92, 160, 48, 192, 3, 1),
}
# Three of the 36 1×1 convs, on the GEMM kernel: the largest M
# (blocks_1_0.conv_pwl, 64 → 32 at 184×320), the largest K
# (blocks_5_7.conv_pwl, 1152 → 192 at 23×40) and the largest N
# (blocks_5_7.conv_pw, 192 → 1152 at 23×40, as blocks_5_1..6).
INT8_MM_SHAPES = {
    "int8_gemm_blocks_1_0_pwl": (2 * CHUNK, 184, 320, 64, 32, 1, 1),
    "int8_gemm_blocks_5_7_pwl": (2 * CHUNK, 23, 40, 1152, 192, 1, 1),
    "int8_gemm_blocks_5_7_pw": (2 * CHUNK, 23, 40, 192, 1152, 1, 1),
}
# The k×k conv kernel of csrc/int8_conv.cu, which the five k×k shapes no
# longer take, at blocks_2_0's shape in float32 (a float32 int8 engine's),
# whose two ring stages the 3×3 kernel cannot fit.
INT8_CONV_SHAPES = {
    "int8_conv_blocks_2_0_float32": (2 * CHUNK, 184, 320, 32, 128, 3, 2),
}
INT8_SLICE = 16  # images per float64 slice of the plain version
# The int8 conv's edge shapes through the op's CUDA route, each against the
# plain version, exactly: (N, H, W, C, O, k, stride), the compute dtype (of x
# and the output; the int32 sums are checked too), x's offset in elements
# past a 16-byte boundary (its rows then copied byte by byte), and the
# kernel the shape takes. On the 3×3 kernel (each of its six instances):
# ragged row and column tiles (H 23, W 40) with C 16 (two taps a k32 step)
# and C_out 16 (three consumers, 16 × 16 tiles); C 8 in float16; C 48 (a
# step across two taps) to C_out 192 at odd H and W; stride 2 at odd H and
# W (the extra SAME row and column); float16 at stride 2 to C_out 128 (two
# consumers: a third's ring does not fit); C 24 (a unit's tail past C) to O
# 40; float32 to O 72 (three consumers); float32 to C_out 16 (two
# consumers, 8 × 16 tiles); C 48 to C_out 16. On the conv
# kernel: odd H and W at stride 2 and a part channel tile (O 24) in
# float32, whose ring the 3×3 kernel cannot fit; ragged tiles at an odd O;
# C 8 to O 12; a 1×1 at stride 2, a 1×1 of 8 pixels (M ≤ 16) and a 1×1 with
# an odd O; an odd O at k3 (single-channel stores); C 80 (two passes, 64 +
# 16 channels) and O 72; the 1×1 at K 1152 on 12 pixels (18 passes); k 5;
# a misaligned x; a 1×1 whose x is misaligned and one whose bf16 rows (C
# 12) are not a multiple of 16 bytes, which TMA cannot read; a 3×3 at
# stride 2 whose two ring stages do not fit. On the GEMM kernel: K 96; C 24
# in float16 (a K tail inside one k32 step, weights resident); K 1152
# (weights in the ring) and O 130 (a part N sub-tile) over ragged rows;
# float32; an M tail below one 64-row tile; K 80 (a tail chunk); C_out
# 1152 over ragged rows (nine N sub-tiles on one quantized x); K 1152 and
# C_out 1152 (x through the ring again for each N sub-tile); float32 with
# weights in the ring.
INT8_EDGE_CASES = [
    ((2, 23, 40, 16, 16, 3, 1), torch.bfloat16, 0, "conv3x3"),
    ((3, 9, 33, 48, 24, 3, 2), torch.float32, 0, "conv"),
    ((2, 11, 13, 8, 8, 3, 1), torch.float16, 0, "conv3x3"),
    ((2, 9, 10, 24, 40, 1, 2), torch.bfloat16, 0, "conv"),
    ((1, 2, 4, 16, 16, 1, 1), torch.bfloat16, 0, "conv"),
    ((2, 23, 40, 32, 17, 1, 1), torch.bfloat16, 0, "conv"),
    ((2, 12, 20, 32, 17, 3, 1), torch.float32, 0, "conv"),
    ((2, 15, 17, 80, 72, 3, 2), torch.bfloat16, 0, "conv"),
    ((1, 3, 4, 1152, 192, 1, 1), torch.bfloat16, 0, "conv"),
    ((2, 13, 21, 32, 32, 5, 2), torch.float32, 0, "conv"),
    ((2, 10, 12, 32, 64, 3, 1), torch.bfloat16, 1, "conv"),
    ((4, 23, 40, 96, 24, 1, 1), torch.bfloat16, 0, "gemm"),
    ((2, 9, 11, 24, 40, 1, 1), torch.float16, 0, "gemm"),
    ((2, 7, 9, 32, 48, 1, 1), torch.bfloat16, 1, "conv"),
    ((2, 23, 40, 1152, 130, 1, 1), torch.bfloat16, 0, "gemm"),
    ((3, 5, 7, 48, 96, 1, 1), torch.float32, 0, "gemm"),
    ((2, 9, 10, 12, 16, 1, 1), torch.bfloat16, 0, "conv"),
    ((1, 5, 6, 64, 32, 1, 1), torch.bfloat16, 0, "gemm"),
    ((2, 9, 13, 80, 48, 1, 1), torch.bfloat16, 0, "gemm"),
    ((2, 7, 9, 192, 1152, 1, 1), torch.bfloat16, 0, "gemm"),
    ((1, 5, 13, 1152, 1152, 1, 1), torch.bfloat16, 0, "gemm"),
    ((1, 3, 30, 1152, 192, 1, 1), torch.float32, 0, "gemm"),
    ((2, 15, 17, 48, 192, 3, 1), torch.bfloat16, 0, "conv3x3"),
    ((2, 15, 17, 16, 64, 3, 2), torch.bfloat16, 0, "conv3x3"),
    ((3, 9, 33, 32, 128, 3, 2), torch.float16, 0, "conv3x3"),
    ((2, 10, 12, 24, 40, 3, 1), torch.bfloat16, 0, "conv3x3"),
    ((2, 7, 9, 32, 72, 3, 1), torch.float32, 0, "conv3x3"),
    ((2, 12, 20, 32, 16, 3, 1), torch.float32, 0, "conv3x3"),
    ((2, 9, 21, 48, 16, 3, 1), torch.bfloat16, 0, "conv3x3"),
    ((2, 23, 40, 16, 17, 3, 1), torch.bfloat16, 0, "conv"),
    ((2, 11, 13, 8, 12, 3, 1), torch.float16, 0, "conv"),
    ((2, 37, 29, 32, 16, 3, 2), torch.bfloat16, 0, "conv"),
]
# The int8 kernels of the op's CUDA route, in the order of
# ``int8_route_counts``.
INT8_ROUTES = {"conv": int8_ops.KERNEL, "gemm": int8_ops.GEMM_KERNEL,
               "conv3x3": int8_ops.CONV3X3_KERNEL}


def bound_int8(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_inputs(dev, shape: tuple, seed: int, dtype=torch.bfloat16, offset: int = 0):
    """Seeded x (N, H, W, C) in ``dtype`` (``offset`` elements into its
    buffer) with an outlier, its s_x from ``activation_scale``, a seeded int8
    w_q (O, k, k, C), an s_w of the size ``weight_scale`` gives, and the TF
    SAME pads."""
    n, h, w, c, o, k, s = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn((n * h * w * c + offset,), generator=g, device=dev).to(dtype)
    x = flat[offset:].view(n, h, w, c)
    x.view(-1)[x.numel() // 2] = 12.0
    w_q = torch.randint(-127, 128, (o, k, k, c), generator=g, device=dev, dtype=torch.int8)
    s_w = torch.rand((o,), generator=g, device=dev) * 1e-2 + 1e-4
    return x, activation_scale(abs_max(x)), w_q, s_w, (*same_pad(h, k, s), *same_pad(w, k, s))


def int8_plain_slices(x, s_x, w_q, s_w, stride, pads, out_dtype):
    """The plain version over the batch in slices of ``INT8_SLICE`` images
    (float64 at full batch would not fit beside the kernel's tensors)."""
    for b0 in range(0, x.shape[0], INT8_SLICE):
        yield b0, int8_conv2d_reference(x[b0:b0 + INT8_SLICE], s_x, w_q, s_w, stride, *pads,
                                        out_dtype)


def int8_exact(name: str, out: torch.Tensor, x, s_x, w_q, s_w, stride, pads) -> None:
    """``out`` against the plain version, slice by slice: every element
    equal, or the run fails."""
    for b0, ref in int8_plain_slices(x, s_x, w_q, s_w, stride, pads, out.dtype):
        got = out[b0:b0 + INT8_SLICE]
        if not torch.equal(got, ref):
            diff = (got.double() - ref.double()).abs().max().item()
            fail(f"{name}: the int8 conv's {out.dtype} output differs from the plain version "
                 f"by {diff} in images {b0}..{b0 + len(ref) - 1}")


def int8_route_counts(fn) -> tuple:
    """One call of ``fn`` and the launches it made of each kernel of
    ``INT8_ROUTES``, in that order."""
    before = [k.launches for k in INT8_ROUTES.values()]
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(k.launches - b for k, b in zip(INT8_ROUTES.values(), before))


def int8_route_expected(route: str) -> tuple:
    return tuple(int(r == route) for r in INT8_ROUTES)


def check_int8_edges(dev) -> None:
    """The op's CUDA route against its plain version at
    ``INT8_EDGE_CASES``: the shape's kernel launched once, the output (and
    the int32 sums) equal to the plain version's."""
    t0 = time.perf_counter()
    for i, (shape, dtype, offset, route) in enumerate(INT8_EDGE_CASES):
        x, s_x, w_q, s_w, pads = int8_inputs(dev, shape, 100 + i, dtype, offset)
        s = shape[-1]
        for out_dtype in (dtype, torch.int32):
            out, counts = int8_route_counts(
                lambda: int8_conv2d(x, s_x, w_q, s_w, s, pads, out_dtype))
            if counts != int8_route_expected(route):
                fail(f"int8 edge {shape}: {counts} launches of {list(INT8_ROUTES)}, "
                     f"expected {int8_route_expected(route)}")
            int8_exact(f"int8 edge {shape} {out_dtype}", out, x, s_x, w_q, s_w, s, pads)
    log({"check": "int8_conv_edges", "cases": len(INT8_EDGE_CASES), "max_abs_diff": 0.0,
         "seconds": time.perf_counter() - t0})


def check_int8(dev, name: str, shape: tuple, seed: int) -> dict:
    """One flagship conv of ``INT8_SHAPES`` (the 3×3 kernel, bf16),
    ``INT8_MM_SHAPES`` (the GEMM kernel, bf16) or ``INT8_CONV_SHAPES`` (the
    conv kernel, float32) on a seeded x: the route's launch counts, the
    int32 sums and the compute-dtype output equal to the plain version's,
    then the times (the op's; the kernel's wrapper called directly; the
    kernel's device time) beside the bound (x read once, int8 weights, the
    output written once), the plain version's (float64, in slices) and the
    yardstick's: for a 1×1 conv ``torch._int_mm`` on the quantized x
    (``library_ms``, the s8 product alone); for a k×k conv, which no PyTorch
    call computes in s8, cuDNN's conv of the same shape in the compute dtype
    (``cudnn_bf16_ms``, ``cudnn_float32_ms``)."""
    n, h, w, c, o, k, s = shape
    route = "gemm" if name in INT8_MM_SHAPES else "conv" if name in INT8_CONV_SHAPES else "conv3x3"
    dtype = torch.float32 if route == "conv" else torch.bfloat16
    es = torch.empty((), dtype=dtype).element_size()
    kernel = INT8_ROUTES[route]
    x, s_x, w_q, s_w, pads = int8_inputs(dev, shape, seed, dtype)
    call = lambda out_dtype=dtype: int8_conv2d(x, s_x, w_q, s_w, s, pads, out_dtype)  # noqa: E731
    sums, counts = int8_route_counts(lambda: call(torch.int32))
    if counts != int8_route_expected(route):
        fail(f"{name}: {counts} launches of {list(INT8_ROUTES)}, expected "
             f"{int8_route_expected(route)}")
    int8_exact(f"{name} sums", sums, x, s_x, w_q, s_w, s, pads)
    del sums
    out, _ = int8_route_counts(call)
    int8_exact(f"{name} {dtype}", out, x, s_x, w_q, s_w, s, pads)
    ho, wo = out.shape[1:3]
    del out
    direct = {
        "gemm": lambda: int8_ops.int8_gemm_cuda(x, s_x, w_q, s_w, dtype),
        "conv3x3": lambda: int8_ops.int8_conv3x3_cuda(x, s_x, w_q, s_w, s, pads, dtype),
        "conv": lambda: int8_ops.int8_conv_cuda(x, s_x, w_q, s_w, s, pads, dtype),
    }[route]
    nbytes = x.numel() * es + w_q.numel() + n * ho * wo * o * es + o * 4 + 4
    bound_ms, bound_by = bound_int8(nbytes, 2 * n * ho * wo * o * k * k * c)
    dname = str(dtype).removeprefix("torch.")
    row = {
        "name": name, "path": "int8 inference, TTA on", "shape": list(shape),
        "dtype": f"{dname} -> int8 -> {dname}", "max_abs_diff": 0.0,
        "launches_per_call": 1, "kernel_ms": median_ms(call), "direct_ms": median_ms(direct),
        "device_ms": device_ms_events(call, kernel),
        "device_ms_method": "cuda_events_behind_sleep",
        "plain_ms": median_ms(lambda: list(int8_plain_slices(x, s_x, w_q, s_w, s, pads, dtype)),
                              reps=2, warmup=1),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if route == "gemm":
        x2, w2 = quantize(x, s_x).reshape(-1, c), w_q.reshape(o, c).t()
        row["library_ms"] = median_ms(lambda: torch._int_mm(x2, w2))
        row["library"] = "torch._int_mm on the quantized x (int32 sums, no dequantize)"
        del x2
    del x
    torch.cuda.empty_cache()
    if route != "gemm":
        g = torch.Generator(device=dev).manual_seed(seed)
        xb = torch.randn((n, c, h, w), generator=g, device=dev).to(
            dtype).contiguous(memory_format=torch.channels_last)
        wb = torch.randn((o, c, k, k), generator=g, device=dev).to(
            dtype).contiguous(memory_format=torch.channels_last)
        key = "cudnn_bf16_ms" if dtype == torch.bfloat16 else "cudnn_float32_ms"
        row[key] = median_ms(lambda: F.conv2d(xb, wb, stride=s, padding=k // 2))
        del xb, wb
        torch.cuda.empty_cache()
    log(row)
    return row


def int8_kernel_checks(dev, launches: dict) -> dict:
    """Phase 12's kernel rows: the edge shapes (the path ``int8_edges``),
    the five k×k shapes on the 3×3 kernel, the three 1×1 shapes on the GEMM
    kernel and the float32 shape on the conv kernel."""
    t0 = time.perf_counter()
    counted("int8_edges", launches, lambda: check_int8_edges(dev))
    shapes = {**INT8_SHAPES, **INT8_MM_SHAPES, **INT8_CONV_SHAPES}
    rows = {name: check_int8(dev, name, shape, 40 + i)
            for i, (name, shape) in enumerate(shapes.items())}
    log({"phase": "int8_kernel_checks_done", "seconds": time.perf_counter() - t0})
    return rows


INT8_K_CONVS, INT8_MM_CONVS = 5, 36  # the flagship encoder's quantized convs, k×k and 1×1
INT8_DRIFT = 0.15    # JAX's bound of the int8 sigmoids' drift (tests/test_quantize.py)
# Two int8 paths whose bf16 convs differ upstream (cuDNN plans for other
# batch and window shapes, C2) move activations across rounding boundaries,
# each flip one int8 step, through 41 layers: held to JAX's drift bound
# (on an H100 80GB HBM3 at 700 W, sp 1×2 against unsplit read 0.032, the
# drift from bf16 0.037). The CPU tests hold the same paths to JAX in
# float32.
INT8_PATHS_ATOL = INT8_DRIFT
INT8_STREAM_FRAMES = 96
INT8_TICK_BUCKETS = (1, 8, 16)
INT8_PROFILE_OPS = ("bas_torch::int8_conv2d", "aten::linalg_vector_norm", "aten::mul",
                    "aten::clamp_min")
# Ops of the separate quantize, weight-quantize and dequantize passes and of
# the _int_mm route: an int8 chunk program may run none of them more often
# than the bf16 program of the same engine does.
INT8_PASS_OPS = ("aten::_int_mm", "aten::div", "aten::div_", "aten::round", "aten::round_",
                 "aten::clamp", "aten::clamp_", "aten::amax", "aten::_to_copy")


def quant_layers(model) -> list:
    """[(name, module)] of the model's quantized convs (the grouped ones run
    the compute-dtype conv)."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QuantConv) and m.groups == 1]


def hold_quant_layer(name: str, mod, x: torch.Tensor, out: torch.Tensor) -> None:
    """One quantized conv's output against the plain version on its input:
    the weight quantized afresh by ``weight_scale`` (the layer's cached one
    must be its bits), the activation's scale as ``QuantConv`` takes it, and
    ``int8_conv2d_reference`` (quantize, float64 sums, dequantize) in slices
    of the batch, every element equal."""
    w_q, s_w = weight_scale(mod.weight)
    s_x = activation_scale(abs_max(x))
    k, s = w_q.shape[1], mod.stride
    pads = (*same_pad(x.shape[2], k, s), *same_pad(x.shape[3], k, s))
    for b0 in range(0, x.shape[0], INT8_SLICE):
        ref = int8_conv2d_reference(x[b0:b0 + INT8_SLICE].permute(0, 2, 3, 1), s_x, w_q, s_w,
                                    s, *pads, x.dtype)
        if not torch.equal(out[b0:b0 + INT8_SLICE].permute(0, 2, 3, 1), ref):
            diff = (out[b0:b0 + INT8_SLICE].permute(0, 2, 3, 1).float() - ref.float())
            fail(f"int8 layer {name} differs from the plain version by {diff.abs().max().item()}")


def int8_hooked_chunk(predictor, frames: np.ndarray) -> int:
    """One chunk program of the int8 engine with a forward hook on each of
    its quantized convs that holds the layer against the plain version
    (``hold_quant_layer``); returns the count of layers held."""
    layers = quant_layers(predictor.model)
    held = []

    def hook(name):
        def check(mod, args, out):
            hold_quant_layer(name, mod, args[0], out)
            held.append(name)
        return check

    with torch.inference_mode():
        new, carry = staged_chunk(predictor, frames)
        handles = [m.register_forward_hook(hook(name)) for name, m in layers]
        try:
            predictor.chunk_features(new, carry)
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
    if sorted(held) != sorted(name for name, _ in layers):
        fail(f"the hooks held {len(held)} of {len(layers)} quantized layers")
    return len(held)


@contextlib.contextmanager
def plain_int8():
    """The int8 convs by their plain version (quantize, float64 sums,
    dequantize) on any device, in place of the kernels."""
    op = int8_ops.int8_conv2d_op
    int8_ops.int8_conv2d_op = int8_conv2d_reference
    try:
        yield
    finally:
        int8_ops.int8_conv2d_op = op


def int8_features(dev, bf16, int8, frames: np.ndarray, count: int = 32) -> dict:
    """The int8 encoder's features on ``count`` stacks of the video against
    the same encoder with the plain s8 product (every element equal) and
    against the bf16 encoder (the correlation, logged; JAX's test holds its
    tiny arch above 0.99, which ``tests/test_torch_quantize.py`` holds the
    port to, while 41 per-tensor quantized layers of the seeded flagship
    drift further)."""
    reach = (bf16.model_stack_size - 1) * bf16.frame_stack_step
    with torch.inference_mode():
        x = bf16.normalize_stacks(bf16._stacks(torch.from_numpy(frames[:count + reach]).to(dev),
                                               count))
        ref = bf16.model.forward_2d_nhwc(x).float()
        got = int8.model.forward_2d_nhwc(x).float()
        with plain_int8():
            plain = int8.model.forward_2d_nhwc(x).float()
    if not torch.equal(got, plain):
        fail(f"int8 encoder features differ from the plain s8 product's by "
             f"{(got - plain).abs().max().item()}")
    corr = float(np.corrcoef(ref.flatten().cpu().numpy(), got.flatten().cpu().numpy())[0, 1])
    rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    row = {"check": "int8_encoder_features", "stacks": count, "equal_to_plain": True,
           "corr_vs_bf16": corr, "mean_rel_drift_vs_bf16": rel}
    log(row)
    return row


def int8_profile(predictor, frames: np.ndarray, chunks: int = 2) -> dict:
    """Device ms a chunk program of an engine by op (torch.profiler's device
    time under each op of ``INT8_PROFILE_OPS``: the int8 op, the abs-max and
    the scale's product and clamp), its busy ms, the three int8 kernels' own
    ms, the calls of each op of ``INT8_PASS_OPS`` and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        new, carry = staged_chunk(predictor, frames)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(chunks):
                _, carry = predictor.chunk_features(new, carry)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / chunks
    busy_ms, summed_ms, top = device_time(prof, chunks, 120, 12)
    by_op = {e.key: e.device_time_total / 1e3 / chunks for e in prof.key_averages()
             if e.key in INT8_PROFILE_OPS}
    kernel_ms = {route: sum(e.self_device_time_total for e in prof.key_averages()
                            if name in e.key) / 1e3 / chunks
                 for route, name in (("conv", "int8_kernel<"), ("gemm", "int8_gemm_kernel<"),
                                     ("conv3x3", "int8_conv3x3_kernel<"))}
    calls = {e.key: e.count // chunks for e in prof.key_averages() if e.key in INT8_PASS_OPS}
    return {"tta": predictor.tta, "wall_ms_per_chunk": wall_ms,
            "device_busy_ms_per_chunk": busy_ms, "kernel_sum_ms_per_chunk": summed_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "int8_conv_kernel_ms_per_chunk": kernel_ms["conv"],
            "int8_conv3x3_kernel_ms_per_chunk": kernel_ms["conv3x3"],
            "int8_gemm_kernel_ms_per_chunk": kernel_ms["gemm"], "device_ms_by_op": by_op,
            "pass_op_calls_per_chunk": {op: calls.get(op, 0) for op in INT8_PASS_OPS},
            "top": top}


def int8_gemm_chunk_bound(predictor, frames: np.ndarray) -> dict:
    """The 1×1 convs that one chunk program of ``predictor`` hands the int8
    op with a shape the GEMM kernel takes (``gemm_takes``), recorded at the
    op, and their summed byte bound: x in the compute dtype read once, the
    int8 weights, the output written once, s_w and s_x."""
    shapes = []
    op = int8_ops.int8_conv2d_op

    def record(x, s_x, w_q, s_w, stride, pt, pb, pl, pr, out_dtype):
        if int8_ops.gemm_takes(x, w_q, stride, (pt, pb, pl, pr)):
            shapes.append((x.shape[0] * x.shape[1] * x.shape[2], x.shape[3], w_q.shape[0],
                           x.element_size(), torch.empty((), dtype=out_dtype).element_size()))
        return op(x, s_x, w_q, s_w, stride, pt, pb, pl, pr, out_dtype)

    with torch.inference_mode():
        new, carry = staged_chunk(predictor, frames)
        int8_ops.int8_conv2d_op = record
        try:
            predictor.chunk_features(new, carry)
            torch.cuda.synchronize()
        finally:
            int8_ops.int8_conv2d_op = op
    nbytes = sum(m * c * es + o * c + m * o * oes + 4 * o + 4 for m, c, o, es, oes in shapes)
    return {"gemm_convs_per_chunk": len(shapes), "gemm_bytes_per_chunk": nbytes,
            "gemm_bound_ms_per_chunk": nbytes / HBM_BYTES_PER_S * 1e3}


def int8_flagship(dev, card: str, weights, frames: np.ndarray, raw_bf16: np.ndarray,
                  launches: dict) -> dict:
    """The flagship int8 engine (bf16, chunk 128, feature carry) over the
    inference phase's video: the main path TTA on with the launch counters
    at 0 (5 launches of the 3×3 kernel, 36 of the GEMM kernel and none of
    the conv kernel an encoder call: 3 chunk programs and the bootstrap), the 41 layers of a TTA-off chunk held
    against the plain version, the drift from bf16 (the sigmoids within
    JAX's bound; the encoder features equal to the plain version's, their
    correlation with bf16 logged), device and end-to-end fps against bf16
    in turns, and a chunk profile TTA off and on, whose calls of each op of
    ``INT8_PASS_OPS`` (separate quantize, weight-quantize and dequantize
    passes, ``_int_mm``) are at most the bf16 program's."""
    expected = len(frames) - 30

    def engine(**kw):
        return ChunkedVideoPredictor(weights=weights, device=dev, chunk_size=CHUNK,
                                     dw3d_use_kernel=True, **kw)

    main = engine(tta=True, conv_int8=True)
    layers = quant_layers(main.model)
    if len(layers) != INT8_K_CONVS + INT8_MM_CONVS:
        fail(f"the flagship int8 encoder has {len(layers)} quantized convs")
    run_video(main, frames[:CHUNK + 30])  # warm-up
    idx, raw, secs = counted("int8_inference", launches, lambda: run_video(main, frames))
    check_outputs("int8 main path", idx, raw, expected)
    got = launches["int8_inference"]
    calls = CHUNKS + 1  # the chunk programs and the bootstrap
    if (got["int8_conv3x3"] != INT8_K_CONVS * calls or got["int8_conv"] != 0
            or got["int8_gemm"] != INT8_MM_CONVS * calls
            or got["gem"] != CHUNKS or got["dwconv3d"] != CHUNKS * DW_PER_CHUNK):
        fail(f"the int8 main path launched {got}, expected {INT8_K_CONVS * calls} int8 3×3 "
             f"convs and no other int8 conv, {INT8_MM_CONVS * calls} int8 GEMMs, {CHUNKS} GeM, "
             f"{CHUNKS * DW_PER_CHUNK} dwconv3d")
    drift = agree("int8_vs_bf16_tta_on", raw, raw_bf16, INT8_DRIFT)
    out = {"card": card, "drift_vs_bf16_tta_on": drift,
           "prediction_corr_vs_bf16": float(np.corrcoef(raw.ravel(), raw_bf16.ravel())[0, 1]),
           "launches": got}
    t0 = time.perf_counter()
    off = engine(conv_int8=True)
    out["layers_held_exactly"] = int8_hooked_chunk(off, frames)
    out["hooked_chunk_seconds"] = time.perf_counter() - t0
    out["encoder_features"] = int8_features(dev, engine(), off, frames)
    fps = {}
    for tta in (False, True):
        pair = {"bf16": engine(tta=tta), "int8": engine(tta=tta, conv_int8=True)}
        for name, e in pair.items():
            run_video(e, frames[:CHUNK + 30])
        for name in ("bf16", "int8", "int8", "bf16"):  # in turns
            _, _, secs = run_video(pair[name], frames)
            key = f"{name}_tta_{'on' if tta else 'off'}"
            fps.setdefault(f"{key}_end_to_end_fps", []).append(expected / secs)
            fps.setdefault(f"{key}_device_fps", []).append(device_fps(pair[name], frames))
        prof = int8_profile(pair["int8"], frames)
        bf16_calls = int8_profile(pair["bf16"], frames)["pass_op_calls_per_chunk"]
        extra = {op: n for op, n in prof["pass_op_calls_per_chunk"].items()
                 if n > bf16_calls[op]}
        if extra:
            fail(f"the int8 chunk program (TTA {tta}) runs separate passes: {extra} calls a "
                 f"chunk against bf16's {bf16_calls}")
        prof["bf16_pass_op_calls_per_chunk"] = bf16_calls
        out[f"profile_int8_tta_{'on' if tta else 'off'}"] = prof
        if not tta:  # the GEMM kernel's time a chunk against its summed bound
            gemm = {"check": "int8_gemm_chunk", "card": card, "tta": "off",
                    "gemm_kernel_ms_per_chunk": prof["int8_gemm_kernel_ms_per_chunk"],
                    "conv3x3_kernel_ms_per_chunk": prof["int8_conv3x3_kernel_ms_per_chunk"],
                    **int8_gemm_chunk_bound(pair["int8"], frames),
                    "build_seconds": {k.name: k.build_seconds for k in INT8_ROUTES.values()}}
            if gemm["gemm_convs_per_chunk"] != INT8_MM_CONVS:
                fail(f"a TTA-off int8 chunk handed the GEMM kernel {gemm['gemm_convs_per_chunk']} "
                     f"convs, expected {INT8_MM_CONVS}")
            ms = gemm["gemm_kernel_ms_per_chunk"]
            gemm["share_of_bound"] = gemm["gemm_bound_ms_per_chunk"] / ms if ms > 0 else None
            log(gemm)
            out["gemm_chunk"] = gemm
        del pair
        torch.cuda.empty_cache()
    out["fps"] = {k: statistics.mean(v) for k, v in fps.items()}
    out["fps_runs"] = fps
    for tta in ("off", "on"):
        for kind in ("device", "end_to_end"):
            out["fps"][f"int8_over_bf16_{kind}_tta_{tta}"] = (
                out["fps"][f"int8_tta_{tta}_{kind}_fps"] / out["fps"][f"bf16_tta_{tta}_{kind}_fps"])
    log({"phase": "int8_flagship", **out})
    return out


def int8_engines(dev, card: str, weights, frames: np.ndarray, launches: dict) -> dict:
    """int8 through the other engines at the flagship's width, each path
    with the launch counters at 0: ``StreamingPredictor`` against the
    chunked engine (their encoder batches differ, so their scales do: held
    to JAX's drift bound); the device-state engine on a feed of 4 streams
    and its tick ms at ``INT8_TICK_BUCKETS`` beside the 40-ms limit; the sp
    1×2 grid of the one card (or two cards) against the unsplit frame-carry
    engine, and both engines' device fps in turns; the frame-carry engine exported with ``torch.export`` and
    reloaded, against the live engine (bf16's tolerance: the same program);
    the data-share grid on the visible cards (the one card twice) against
    one device. The grids are held to ``INT8_PATHS_ATOL``."""
    out = {"card": card}
    kw = dict(weights=weights, device=dev, tta=True, conv_int8=True)
    n = INT8_STREAM_FRAMES
    _, c_raw, _ = run_video(ChunkedVideoPredictor(chunk_size=32, **kw), frames[:n])
    streaming = StreamingPredictor(**kw)
    get_raw_predictions(streaming, FramesSource(frames[:40]), 40)  # warm-up
    s_idx, s_raw = counted("int8_streaming", launches, lambda: get_raw_predictions(
        streaming, FramesSource(frames[:n]), n))
    check_outputs("int8 streaming", s_idx, s_raw, n - SERVE_WINDOW - 1)
    out["streaming_vs_chunked"] = agree("int8_streaming_vs_chunked", s_raw, c_raw,
                                        INT8_PATHS_ATOL)
    del streaming

    device_state = DeviceStateMultiStreamPredictor(slot_capacity=max(INT8_TICK_BUCKETS), **kw)
    device_state.warmup(4)

    def feed():
        preds = []
        for i in range(40):
            preds += [p for _, p, _ in _to_host(device_state.predict_batch(
                [(s, frames[(i + 7 * s) % len(frames)], i) for s in range(4)])) if p is not None]
        return preds

    preds = counted("int8_serve_device", launches, feed)
    if len(preds) != 4 * (40 - SERVE_WINDOW + 1) or not all(np.isfinite(p).all() for p in preds):
        fail(f"int8 device-state feed: {len(preds)} predictions")
    ticks = {b: device_state_tick_ms(device_state, b)[0] for b in INT8_TICK_BUCKETS}
    out["device_state_tick_ms"] = ticks
    out["ticks_within_40_ms"] = {b: ms <= REALTIME_MS for b, ms in ticks.items()}
    del device_state
    torch.cuda.empty_cache()

    one = ChunkedVideoPredictor(chunk_size=CHUNK, carry_features=False, dw3d_use_kernel=True, **kw)
    _, raw_one, _ = run_video(one, frames)
    devices = sp_grids(dev)[0][2][:2]
    sp = ChunkedVideoPredictor(weights=weights, chunk_size=CHUNK, tta=True, conv_int8=True,
                               mesh=make_mesh(1, 2, devices), spatial=True)
    run_video(sp, frames[:CHUNK + 30])
    _, raw_sp, _ = counted("int8_sp_1x2", launches, lambda: run_video(sp, frames))
    out["sp_1x2_vs_unsplit"] = agree("int8_sp_1x2_vs_unsplit", raw_sp, raw_one, INT8_PATHS_ATOL)
    # what the grid costs int8: device fps, TTA on, unsplit and sp 1x2 in
    # turns (A B B A), and the halo traffic of the float windows
    timed = {"unsplit": [], "sp_1x2": []}
    for name in ("unsplit", "sp_1x2", "sp_1x2", "unsplit"):
        engine, on = (one, [dev]) if name == "unsplit" else (sp, devices)
        fps, halo = sp_device_fps(engine, frames, on)
        timed[name].append(fps)
        if engine is sp:
            out["sp_1x2_halo"] = halo
    out["sp_1x2_device_fps_tta_on"] = {name: statistics.mean(v) for name, v in timed.items()}
    out["sp_1x2_device_fps_runs"] = timed
    del sp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        art = export_chunked_predictor(one, Path(tmp) / "int8.bastorx")
        sealed = ExportedChunkPredictor(art, device=dev)
        out["export_seconds"] = time.perf_counter() - t0
        nodes = op_nodes(sealed.program)
        targets = [str(nd.target) for nd in sealed.program.graph.nodes
                   if nd.op == "call_function"]
        nodes["int8_conv2d"] = targets.count("bas_torch.int8_conv2d.default")
        if nodes != {"gem_pool": 1, "dwconv3d": DW_PER_CHUNK, "warp_resample": 0,
                     "bias_act": folded_bns(one.model),
                     "int8_conv2d": INT8_K_CONVS + INT8_MM_CONVS}:
            fail(f"the exported int8 program holds {nodes} custom-op nodes")
        sealed.predict_video(iter(enumerate(frames[:CHUNK + 30])), CHUNK + 30)
        _, raw_sealed = counted("int8_export", launches, lambda: sealed.predict_video(
            iter(enumerate(frames)), len(frames)))
        out["export_vs_live"] = agree("int8_export_vs_live", raw_sealed, raw_one, PRED_BF16_ATOL)
        out["export_op_nodes"] = nodes
        del sealed
    cards = parallel_devices(dev)
    grid = ChunkedVideoPredictor(weights=weights, chunk_size=CHUNK, tta=True, conv_int8=True,
                                 carry_features=False, dw3d_use_kernel=True,
                                 mesh=make_mesh(len(cards), 1, cards))
    run_video(grid, frames[:CHUNK + 30])
    _, raw_grid, _ = counted("int8_data_parallel", launches, lambda: run_video(grid, frames))
    on = launches_on()
    out["data_parallel_vs_one"] = agree("int8_data_parallel_vs_one_device", raw_grid, raw_one,
                                        INT8_PATHS_ATOL)
    if any(on[k].get(str(d), 0) < 1 for d in cards for k in ("int8_conv3x3", "int8_gemm")):
        fail(f"the int8 data-share grid did not launch the 3×3 and GEMM kernels on every card: "
             f"{on}")
    out["data_parallel_launches_on"] = on
    del one, grid
    torch.cuda.empty_cache()
    for path in ("int8_streaming", "int8_serve_device", "int8_sp_1x2", "int8_export",
                 "int8_data_parallel"):
        counts = launches[path]
        if counts["int8_conv3x3"] < 1 or counts["int8_gemm"] < 1 \
                or counts["gem"] + counts["gem_partial"] < 1 or counts["dwconv3d"] < 1:
            fail(f"{path} did not launch the int8 3×3 and GEMM kernels, GeM and dwconv3d: "
                 f"{counts}")
    log({"phase": "int8_engines", **out})
    return out


def int8_phase(dev, card: str, weights, video: np.ndarray, raw_bf16: np.ndarray):
    """Phase 12: the int8 encoder convs at the flagship's width: the kernel
    rows, the flagship int8 engine, the other engines; returns each path's
    launches and the kernel rows."""
    t0 = time.perf_counter()
    launches: dict = {}
    rows = int8_kernel_checks(dev, launches)
    torch.cuda.empty_cache()
    flagship_out = int8_flagship(dev, card, weights, video, raw_bf16, launches)
    engines_out = int8_engines(dev, card, weights, video, launches)
    log({"phase": "int8", "card": card, "fps": flagship_out["fps"],
         "seconds": time.perf_counter() - t0, "engines": engines_out})
    return launches, rows


def int8_sources(launches: dict) -> dict:
    """The kernels line's phase-12 rows: the 3×3 kernel at the five k×k
    shapes and the GEMM kernel at the three 1×1 shapes, each launched on the
    int8 main path and every int8 engine's path; the conv kernel, which no
    flagship path launches any more, at its float32 shape with the edge
    cases' path, the one that launches it. They replace no Pallas kernel:
    the JAX package leaves the s8 product to XLA's convolution
    (``models/quantize.py:92``)."""
    paths = {"int8_inference": launches["int8_inference"],
             **{k: v for k, v in launches.items() if k.startswith("int8_")
                and k not in ("int8_inference", "int8_edges")}}
    src = "ball_action_spotting_torch/csrc/"
    replaces = "ball_action_spotting_tpu/models/quantize.py:92"
    edges = {"int8_edges": launches["int8_edges"]}
    return {**{name: ("int8_conv3x3", src + "int8_conv3x3.cu", replaces, paths)
               for name in INT8_SHAPES},
            **{name: ("int8_gemm", src + "int8_gemm.cu", replaces, paths)
               for name in INT8_MM_SHAPES},
            **{name: ("int8_conv", src + "int8_conv.cu", replaces, edges)
               for name in INT8_CONV_SHAPES}}


def device_line() -> dict:
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def kernels_line(sources: dict, rows: dict) -> list:
    """The kernels JSON line's rows: for each ``sources`` entry (row name →
    (count key, source, TPU kernel, {path: launches})), its phase-2 row's
    numbers and its launches on every path that runs it, each of which must
    have launched it."""
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
            **{key: value for key, value in row.items() if key.startswith("cudnn_")},
        })
    if any(not (math.isfinite(k["ms"]) and math.isfinite(k["device_ms"])) for k in kernels):
        fail("a kernel time is not finite")
    return kernels


def spatial_sources(sp_launches: dict) -> dict:
    """The kernels line's phase-11 rows: GeM's band-partial launch and the
    depthwise kernel on band windows, launched on the spatial main path
    (the first grid, TTA on) and the other grids' runs; GeM's also on the
    banded train step (``sp_train``; training's depthwise conv is cuDNN's)."""
    paths = {"sp_predict": sp_launches["sp_predict"],
             **{k: v for k, v in sp_launches.items()
                if k.startswith("sp_") and k not in ("sp_predict", "sp_train")}}
    gem = ("gem_partial", "ball_action_spotting_torch/csrc/gem.cu",
           "ball_action_spotting_tpu/ops/pallas_gem.py:64",
           {**paths, "sp_train": sp_launches["sp_train"]})
    dw = ("dwconv3d", "ball_action_spotting_torch/csrc/dwconv3d.cu",
          "ball_action_spotting_tpu/ops/pallas_dwconv3d.py:105", paths)
    return {**{f"gem_pool_partial_{h}rows": gem for h in SP_GEM_ROWS},
            **{f"dwconv3d_band_{h}rows": dw for h in SP_DW_ROWS}}


def spatial_alone(dev, card: str) -> None:
    """``--phase spatial``: phase 11 after the kernels' build, on the
    inference phase's seeded weights and video, and its kernel rows."""
    video = flagship_video()
    weights = (flagship_weights(dev, video), PARAMS)
    t0 = time.perf_counter()
    launches, rows = spatial(dev, card, weights, video)
    log({"phase": "spatial_done", "seconds": time.perf_counter() - t0, "launches": launches})
    log(card)
    log({"kernels": kernels_line(spatial_sources(launches), rows)})
    log(device_line())


def int8_alone(dev, card: str) -> None:
    """``--phase int8``: phase 12 after the kernels' build, on the inference
    phase's seeded weights and video (its bf16 main path run here for the
    drift), and its kernel rows."""
    video = flagship_video()
    weights = (flagship_weights(dev, video), PARAMS)
    main = ChunkedVideoPredictor(weights=weights, device=dev, chunk_size=CHUNK, tta=True,
                                 dw3d_use_kernel=True)
    run_video(main, video[:CHUNK + 30])
    _, raw_main, _ = run_video(main, video)
    del main
    t0 = time.perf_counter()
    launches, rows = int8_phase(dev, card, weights, video, raw_main)
    log({"phase": "int8_done", "seconds": time.perf_counter() - t0, "launches": launches})
    log(card)
    log({"kernels": kernels_line(int8_sources(launches), rows)})
    log(device_line())


def model_parallel_alone(dev, card: str) -> None:
    """``--phase model_parallel``: phase 10 after the kernels' build, on
    the inference phase's seeded weights and video."""
    video = flagship_video()
    weights = (flagship_weights(dev, video), PARAMS)
    t0 = time.perf_counter()
    launches = model_parallel(dev, card, weights, video)
    log({"phase": "model_parallel_done", "seconds": time.perf_counter() - t0,
         "launches": launches})
    log(card)
    log(device_line())


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", choices=("all", "model_parallel", "spatial", "int8"),
                        default="all",
                        help="model_parallel, spatial, int8: build the kernels, then run phase "
                             "10, 11 or 12 alone")
    args = parser.parse_args()
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
    if args.phase == "model_parallel":
        return model_parallel_alone(dev, card)
    if args.phase == "spatial":
        return spatial_alone(dev, card)
    if args.phase == "int8":
        return int8_alone(dev, card)

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
        **{name: check_bias_act(dev, *case) for name, case in BIAS_ACT_SHAPES.items()},
        **{name: check_se_scale(dev, shape) for name, shape in SE_SCALE_SHAPES.items()},
        "se_scale_s16_planes": check_se_scale(dev, SE_SCALE_PLANES_SHAPE, planes=True),
    }
    torch.cuda.empty_cache()
    warp_rows = {(axis, dtype): check_warp(dev, axis, dtype)
                 for dtype in (torch.bfloat16, torch.float32) for axis in ("rows", "columns")}
    # the augmentation warps in bf16: its H and V passes are the main path's
    rows["warp_resample_h"] = warp_rows["rows", torch.bfloat16]
    rows["warp_resample_v"] = warp_rows["columns", torch.bfloat16]
    log({"phase": "kernel_checks_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    launches, weights, video, raw_main, fps = flagship(dev, card)
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        store_launches = host_data_path(dev, card, fps, Path(work))
    log({"phase": "host_data_path_done", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp_launches = model_parallel(dev, card, weights, video)
    log({"phase": "model_parallel_done", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sp_launches, sp_rows = spatial(dev, card, weights, video)
    rows.update(sp_rows)
    log({"phase": "spatial_done", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    int8_launches, int8_rows = int8_phase(dev, card, weights, video, raw_main)
    rows.update(int8_rows)
    log({"phase": "int8_done", "seconds": time.perf_counter() - t0})

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
    serving_paths["serve_mesh"] = mp_launches["serve_mesh"]
    new_inference_paths = {path: new_launches[path] for path in
                           ("fused", "export", "export_cpu_traced", "data_parallel",
                            "fold_parallel")}
    inference_paths = {"inference": launches, "eval_predict": recipe_launches["eval_predict"],
                       "action_predict": recipe_launches["action_predict"], **serving_paths,
                       **new_inference_paths, "pth_predict": family_launches["pth_predict"],
                       "s2d_predict": family_launches["s2d_predict"],
                       **{path: store_launches[path] for path in
                          ("store_predict", "rehearsal_stage1_predict", "rehearsal_stage3_predict",
                           "rehearsal_stage4_predict", "rehearsal_challenge_predict")}}
    training_paths = {"train": train_launches, "action_train": recipe_launches["action_train"],
                      "stage3_train": recipe_launches["stage3_train"],
                      "dp_train": new_launches["dp_train"],
                      "stage1_pretrained": family_launches["stage1_pretrained"],
                      "stage2_pretrained": family_launches["stage2_pretrained"],
                      **{path: store_launches[path] for path in
                         ("store_train", "rehearsal_stage1_train", "rehearsal_stage2_train",
                          "rehearsal_stage3_train", "rehearsal_stage4_train")},
                      "pp_step": mp_launches["pp_step"], "pp_train": mp_launches["pp_train"]}
    se_paths = {**inference_paths, "multichan": family_launches["multichan"],
                **{k: v for k, v in sp_launches.items() if k.startswith("sp_")},
                **{k: v for k, v in int8_launches.items()
                   if k.startswith("int8_") and k != "int8_edges"},
                **training_paths}
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
                                 ("serve_host", "streaming", "server_host", "serve_mesh")}),
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
        # no Pallas kernel: XLA fuses the folded BN's bias, SiLU and skip into the conv
        **{name: ("bias_act", "ball_action_spotting_torch/csrc/bias_act.cu",
                  "ball_action_spotting_tpu/models/effnetv2.py:202", inference_paths)
           for name in BIAS_ACT_SHAPES},
        # no Pallas kernel: XLA fuses the SE scale into its neighbours; every
        # path through an SE module launches it, training's too, and the
        # space-to-depth stem's on planes
        **{name: ("se_scale", "ball_action_spotting_torch/csrc/se_scale.cu",
                  "ball_action_spotting_tpu/models/effnetv2.py:280", se_paths)
           for name in SE_SCALE_SHAPES},
        "se_scale_s16_planes": ("se_scale_planes", "ball_action_spotting_torch/csrc/se_scale.cu",
                                "ball_action_spotting_tpu/models/effnetv2.py:280",
                                {"s2d_predict": family_launches["s2d_predict"]}),
    }
    sources.update(spatial_sources(sp_launches))
    sources.update(int8_sources(int8_launches))
    kernels = kernels_line(sources, rows)
    log(card)
    log({"kernels": kernels})
    log(device_line())


if __name__ == "__main__":
    sys.exit(main())
