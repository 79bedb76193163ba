"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): kernels and the
flagship chunked inference path.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero):

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of ``ball_action_spotting_torch/csrc`` with nvcc (one process per
   source, all at once), printing the build time and ptxas' report.
2. Holds each kernel against its plain PyTorch version at the flagship
   shapes in bf16, and times kernel, plain version and the one PyTorch call
   that computes the same function (CUDA events, median of 10). Prints one
   JSON line per kernel with its bound on an H100 SXM.
3. Drives the flagship ``ChunkedVideoPredictor`` (EfficientNetV2-b0, 15
   frames, 1280x736, four 3D blocks at 576 channels, chunk 128, bf16,
   seeded random weights) over a synthetic video: hflip TTA on and off, the
   depthwise kernel on and off, feature carry and frame carry. The main
   path (TTA on, kernel on, feature carry) runs with the launch counters
   set to 0 and must launch every kernel. Checks the outputs, the spotting
   JSON, a float32 run against the plain batch forward, and prints fps.
4. Prints the ``kernels`` JSON line, then the device line last.

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

from ball_action_spotting_torch.core.postprocess import raw_predictions_to_actions
from ball_action_spotting_torch.core.spotting import write_game_spotting_results
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.models import build_model, init_weights
from ball_action_spotting_torch.models.effnetv2 import BatchNormAct
from ball_action_spotting_torch.ops import KERNELS
from ball_action_spotting_torch.ops._cuda import build_all
from ball_action_spotting_torch.ops.dwconv3d import (
    dwconv3d,
    dwconv3d_grouped_conv,
    dwconv3d_reference,
)
from ball_action_spotting_torch.ops.gem import gem_pool, gem_pool_reference
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor

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
GEM_GRAD_RTOL = 1e-3   # closed-form backward vs autograd of the plain version
DW_TOL = 2.0 ** -7     # × max|ref|: one bf16 rounding step at the largest output
PRED_BF16_ATOL = 2e-2  # bf16 sigmoid outputs of two conv orders through 4 blocks
PRED_F32_ATOL = 1e-4   # float32 (TF32 off) chunked engine vs plain batch forward


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

def check_gem(dev, num_tta: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((num_tta * CHUNK * 5, 23, 40, 256), generator=g,
                    device=dev).to(torch.bfloat16)
    p = torch.tensor([3.0], device=dev)
    out = gem_pool(x, p)
    ref = gem_pool_reference(x, p)
    err = (out - ref).abs().max().item()
    tol = GEM_TOL * ref.abs().max().item()
    if not err <= tol:
        fail(f"gem kernel vs plain: max|diff| {err} > {tol}")

    # backward: kernel forward + closed-form backward vs autograd of plain
    xf = x[: CHUNK * 5].float().requires_grad_(True)
    pf = p.clone().requires_grad_(True)
    (gem_pool(xf, pf) ** 2).sum().backward()
    xr = xf.detach().clone().requires_grad_(True)
    pr = p.clone().requires_grad_(True)
    (gem_pool_reference(xr, pr) ** 2).sum().backward()
    for name, a, b in (("dx", xf.grad, xr.grad), ("dp", pf.grad, pr.grad)):
        scale = b.abs().max().item()
        if not (a - b).abs().max().item() <= GEM_GRAD_RTOL * scale:
            fail(f"gem backward {name} disagrees with autograd of the plain version")
    del xf, xr

    nbytes = x.numel() * 2 + out.numel() * 4 + 4
    bound_ms, bound_by = bound(nbytes, 5 * x.numel())  # clamp, log, mul, exp, add
    row = {
        "name": "gem_pool", "tta": num_tta == 2, "shape": list(x.shape), "dtype": "bfloat16",
        "max_abs_diff": err, "tolerance": tol,
        "kernel_ms": median_ms(lambda: gem_pool(x, p)),
        "plain_ms": median_ms(lambda: gem_pool_reference(x, p)),
        "library_ms": median_ms(
            lambda: x.float().clamp_min(1e-6).pow(p).mean((1, 2)).pow(1.0 / p)),
        "bound_ms": bound_ms, "bound_by": bound_by, "backward_ok": True,
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
    kernels = [e for e in prof.key_averages()  # device-side activities only
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / chunks
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    row = {
        "phase": "profile", "tta": predictor.tta, "chunks": chunks,
        "wall_ms_per_chunk": wall_ms, "device_busy_ms_per_chunk": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top": [[e.key[:240], e.self_device_time_total / 1e3 / chunks, e.count // chunks]
                for e in kernels[:12]],
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
        k.launches = 0
    idx, raw_main, secs_main = run_video(main, frames)
    launches = {k.name: k.launches for k in KERNELS}
    log({"phase": "main_path", "tta": True, "dw3d_use_kernel": True,
         "launches": launches, "seconds": secs_main})
    if not all(n > 0 for n in launches.values()):
        fail(f"main path did not launch every kernel: {launches}")
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
    # the main path runs hflip TTA, so its shapes are the num_tta=2 ones
    for num_tta in (1, 2):
        rows = {"gem_pool": check_gem(dev, num_tta), "dwconv3d": check_dwconv(dev, num_tta)}
        torch.cuda.empty_cache()
    launches = flagship(dev, card)

    sources = {
        "gem_pool": ("gem", "ball_action_spotting_torch/csrc/gem.cu",
                     "ball_action_spotting_tpu/ops/pallas_gem.py:64"),
        "dwconv3d": ("dwconv3d", "ball_action_spotting_torch/csrc/dwconv3d.cu",
                     "ball_action_spotting_tpu/ops/pallas_dwconv3d.py:105"),
    }
    kernels = []
    for name, (kernel, source, replaces) in sources.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": row["max_abs_diff"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
