"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): kernels, the
flagship chunked inference path and the flagship training path.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero; each prints its seconds):

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of ``ball_action_spotting_torch/csrc`` with nvcc (one process per
   source, all at once), printing the build time and ptxas' report.
2. Holds each kernel against its plain PyTorch version at the main paths'
   shapes, and times kernel, plain version and the one PyTorch call that
   computes the same function (CUDA events, median of 10). Prints one JSON
   line per kernel and shape with its bound on an H100 SXM. GeM at the
   inference head's and the train step's head's shapes in bf16, with its
   backward in float32 and bf16; the depthwise conv at the inference
   shapes in bf16 and at a dozen small edge shapes (``DW_EDGE_CASES``:
   T 1, 2, 5; ragged and whole row tiles; W 1 and 96; C 6, 96, 576;
   float32, bf16, fp16; an x off a 16-byte boundary); the warp resample at
   the train step's H-pass and V-pass shapes in bf16 and float32.
3. Drives the flagship ``ChunkedVideoPredictor`` (EfficientNetV2-b0, 15
   frames, 1280x736, four 3D blocks at 576 channels, chunk 128, bf16,
   seeded random weights) over a synthetic video: hflip TTA on and off, the
   depthwise kernel on and off, feature carry and frame carry. The main
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
5. Prints the ``kernels`` JSON line (one row per kernel and main path:
   GeM on the inference and on the training path, the depthwise conv, and
   the warp's H and V passes, each with its own launches and bound), then
   the device line last.

Float32 comparisons run with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` set False): cuDNN would
otherwise run float32 convolutions in TF32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.models import build_model, init_train_weights, init_weights
from ball_action_spotting_torch.models.effnetv2 import EFFNETV2_ARCHS, BatchNormAct, BlockDef
from ball_action_spotting_torch.ops import KERNELS
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
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor
from ball_action_spotting_torch.train.checkpoint import get_best_checkpoint_path
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step, normalize_frames
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
GEM_TOL = 1e-4         # × max|ref|: f32 sums of the same bf16 inputs, other order
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


def check_gem(dev, shape: tuple, path: str) -> dict:
    """GeM at one of its main-path shapes in bf16: the inference head's
    (num_tta·CHUNK·5, 23, 40, 256) or the train step's head
    (BATCH, 23, 40, 5·256). The backward is checked on the first CHUNK·5
    rows in float32 and in bf16 (the train step's dtype)."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    p = torch.tensor([3.0], device=dev)
    out = gem_pool(x, p)
    ref = gem_pool_reference(x, p)
    err = (out - ref).abs().max().item()
    tol = GEM_TOL * ref.abs().max().item()
    if not err <= tol:
        fail(f"gem kernel vs plain ({path}, {shape}): max|diff| {err} > {tol}")
    backward = {"float32": gem_backward_diffs(x[: CHUNK * 5].float(), p),
                "bfloat16": gem_backward_diffs(x[: CHUNK * 5], p)}
    torch.cuda.empty_cache()

    nbytes = x.numel() * 2 + out.numel() * 4 + 4
    bound_ms, bound_by = bound(nbytes, 5 * x.numel())  # clamp, log, mul, exp, add
    row = {
        "name": "gem_pool", "path": path, "shape": list(x.shape), "dtype": "bfloat16",
        "max_abs_diff": err, "tolerance": tol,
        "kernel_ms": median_ms(lambda: gem_pool(x, p)),
        "plain_ms": median_ms(lambda: gem_pool_reference(x, p)),
        "library_ms": median_ms(
            lambda: x.float().clamp_min(1e-6).pow(p).mean((1, 2)).pow(1.0 / p)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "backward": backward, "grad_rtol": GEM_GRAD_RTOL, "bf16_dx_rounding": GEM_GRAD_ROUND,
    }
    log(row)
    return row


def check_dwconv(dev, num_tta: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((num_tta * CHUNK, 5, 23, 40, 576), generator=g,
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
        "name": "dwconv3d", "tta": num_tta == 2, "shape": list(x.shape), "dtype": "bfloat16",
        "max_abs_diff": err, "tolerance": tol, "library_max_abs_diff": lib_err,
        "kernel_ms": median_ms(lambda: dwconv3d(x, k)),
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
    torch.cuda.synchronize()
    log({"check": "dwconv3d_edge_shapes", "cases": len(DW_EDGE_CASES),
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
           "kernel_ms": median_ms(kernel), "plain_ms": median_ms(plain, reps=3, warmup=1)}
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


def flagship_weights(dev, frames: np.ndarray) -> dict:
    model = build_model("multidim_stacker", **NN_KWARGS)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    clip = torch.from_numpy(frames[0:30:2][None]).to(dev).float() / 255.0
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


def device_time(prof, reps: int, width: int, top: int) -> tuple[float, float, list]:
    """(busy ms, summed kernel ms, top kernels) per repetition of a profiled
    run. Busy time is the union of the device activities' intervals: cuDNN
    may run kernels on several streams at once, so their sum can exceed the
    wall time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, -math.inf
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
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


def flagship(dev, card: str) -> dict:
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

    _, raw_tta_lib, _ = run_video(predictor(tta=True), frames)
    agree("tta_kernel_vs_default", raw_main, raw_tta_lib, PRED_BF16_ATOL)
    _, raw_k, secs_k = run_video(predictor(dw3d_use_kernel=True), frames)
    _, raw_d, _ = run_video(predictor(), frames)
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
        "device_fps_tta_off_default_dwconv": device_fps(predictor(), frames),
    }
    log({"phase": "fps", **fps})
    profile_chunks(predictor(dw3d_use_kernel=True), frames)
    profile_chunks(main, frames)
    return launches


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
            "trainer": trainer, "losses": losses}


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


def training(dev, card: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        main_path = train_main_path(dev, Path(tmp))
        log({"phase": "train_main_path_done", "seconds": time.perf_counter() - t0})
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
    launches = flagship(dev, card)
    log({"phase": "inference_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    train_launches = training(dev, card)
    log({"phase": "training_done", "seconds": time.perf_counter() - t0})

    # one row per kernel and main path; the warp's H and V passes, two
    # launches of one kernel at different shapes and access patterns, each
    # have their own row, launches and bound
    sources = {
        "gem_pool_inference": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                               "ball_action_spotting_tpu/ops/pallas_gem.py:64", launches),
        "gem_pool_train": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                           "ball_action_spotting_tpu/ops/pallas_gem.py:64", train_launches),
        "dwconv3d": ("dwconv3d", "ball_action_spotting_torch/csrc/dwconv3d.cu",
                     "ball_action_spotting_tpu/ops/pallas_dwconv3d.py:105", launches),
        "warp_resample_h": ("warp_H", "ball_action_spotting_torch/csrc/warp.cu",
                            "ball_action_spotting_tpu/ops/pallas_warp.py:96", train_launches),
        "warp_resample_v": ("warp_V", "ball_action_spotting_torch/csrc/warp.cu",
                            "ball_action_spotting_tpu/ops/pallas_warp.py:96", train_launches),
    }
    kernels = []
    for name, (kernel, source, replaces, path_launches) in sources.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[kernel], "max_abs_err": row["max_abs_diff"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    log(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
