"""Time the port's warp-resample, GeM or int8 kernels against another
version of their source, on one NVIDIA GPU, at the main paths' shapes.

    git show <commit>:ball_action_spotting_torch/csrc/warp.cu > build/warp_parent.cu
    python3 kernel_timing.py --kernel warp --other build/warp_parent.cu --other-abi pr5
    python3 kernel_timing.py --kernel gem --other build/gem_parent.cu --other-abi pr5
    python3 kernel_timing.py --kernel gem --other build/gem_parent.cu --other-abi noroot
    git show 1c8d266:ball_action_spotting_torch/csrc/int8_conv.cu > build/int8_conv_int8x.cu
    python3 kernel_timing.py --kernel int8_conv --other build/int8_conv_int8x.cu --other-abi int8x
    git show 630396a:ball_action_spotting_torch/csrc/int8_conv.cu > build/int8_conv_pr16.cu
    python3 kernel_timing.py --kernel int8_conv --other build/int8_conv_pr16.cu
    git show 2051477:ball_action_spotting_torch/csrc/int8_conv.cu > build/int8_gemm_pr16.cu
    python3 kernel_timing.py --kernel int8_gemm --other build/int8_gemm_pr16.cu

Builds ``ball_action_spotting_torch/csrc/<kernel>.cu`` and the ``--other``
source with nvcc as ``ops/_cuda.py`` does and prints ptxas' register
report. The other source exports the same entry point, with the repo's C
interface (``--other-abi current``) or that of PR 5's sources (``pr5``: the
warp took the block-center offsets gathered by the wrapper, GeM had no
16-byte or split mode). A GeM source from before the band-partial launch
takes ``--other-abi noroot``: split sums, but no ``root`` argument. Each
version is held against the plain PyTorch version (``chip_smoke.py``'s
tolerances), then the two are timed in turns, A B B A, each turn the
median over 10 calls of the kernel's own device time (torch.profiler,
``chip_smoke.device_ms``). Shapes, bf16: warp H and V
passes at (60, 736, 1280); GeM at (1280, 23, 40, 256) and (640, 23, 40,
256) (inference, hflip TTA on and off) and (4, 23, 40, 1280) (train head).
Prints the card's ``nvidia-smi`` name and power limit first, then one JSON
line per shape with each version's two medians and the bound.
``--sass DIR`` also writes ``cuobjdump -sass`` of each built library there.

``--kernel int8_conv`` (``--other-abi current``) times the 3×3 kernel
(``csrc/int8_conv3x3.cu``) against another source exporting
``int8_conv_forward`` with the C interface of ``csrc/int8_conv.cu`` (the
k×k conv kernel before the 3×3 one took the flagship's shapes), at
``INT8_SHAPES`` on a seeded bf16 x with s_x from ``activation_scale``: each
version's int32 sums and bf16 output held exactly against the plain
version, then one launch of each timed in turns A B B A, each turn the
median of 10 launches by CUDA events behind a sleeping kernel
(``chip_smoke.device_ms_events``), and cuDNN's bf16 conv of the same shape
beside them (``chip_smoke.median_ms``, as ``chip_smoke.py``'s
``cudnn_bf16_ms``). With ``--other-abi int8x`` it times what a quantized
conv costs on the card, on a seeded bf16 x with s_x from
``activation_scale`` (``chip_smoke.py``'s ``INT8_SHAPES``, the five k×k
convs of a TTA-on chunk, and ``INT8_MM_SHAPES``, three 1×1 convs): the
repo's op, one launch of the 3×3 or the GEMM kernel (``new``), against an
int8-input source
(``--other-abi int8x``: the C interface of the kernel before it quantized
its input, which took int8 x and a float32 (O,) scale and dequantized in
its epilogue) behind the quantize pass (``quantize``, five PyTorch kernels;
``other``); at the 1×1 shapes also the ``_int_mm`` route before the GEMM
kernel (``quantize``, ``torch._int_mm``, ``dequantize``; ``int_mm_route``).
Each version's bf16 output is held exactly against the plain version
(``chip_smoke.int8_exact``); each turn is the median of 10 calls timed by
CUDA events around the call (``chip_smoke.median_ms``: the versions launch
several kernels), in turns A B B A (and the route C first and last).

``--kernel int8_gemm`` times the 1×1 GEMM kernel (``csrc/int8_gemm.cu``)
against another source exporting ``int8_gemm_forward`` with the same C
interface (``--other-abi current``; before ``csrc/int8_gemm.cu`` the entry
point lived in ``csrc/int8_conv.cu``), at ``INT8_MM_SHAPES`` on a seeded
bf16 x with s_x from ``activation_scale``: each version's int32 sums and
bf16 output held exactly against the plain version, then one launch of
each timed in turns A B B A, each turn the median of 10 launches by CUDA
events behind a sleeping kernel (``chip_smoke.device_ms_events``), and
``torch._int_mm`` on the quantized x beside them (``chip_smoke.median_ms``,
as ``chip_smoke.py``'s ``library_ms``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.ops import int8_conv as int8_ops
from ball_action_spotting_torch.ops import warp as warp_ops
from ball_action_spotting_torch.ops._cuda import CudaKernel, build_all, stream_handle
from chip_smoke import (
    CHUNK,
    GEM_TOL,
    INT8_MM_SHAPES,
    INT8_SHAPES,
    WARP_BF16_TOL,
    WARP_N,
    bound,
    bound_int8,
    card_line,
    device_ms,
    device_ms_events,
    int8_exact,
    int8_inputs,
    median_ms,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# PR 5's C interfaces (the repo's are the wrappers' KERNEL signatures):
# warp_resample(img, out, scale, off_c, n, h, w, block, nb, axis, dtype,
# bf16_math, stream), gem_forward(x, p, out, b, hw, c, eps, dtype, stream)
PR5_SIGNATURES = {
    "warp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "gem": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
}
# GeM's C interface before the band-partial launch: gem_forward(x, p, out,
# partial, b, hw, c, eps, dtype, wide, splits, stream), the current one
# without root
NOROOT_SIGNATURES = {"gem": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]}
# The int8 conv before it quantized its input: int8_conv_forward(x_q, w_q,
# scale, out, n, h, w, c, o, k, s, pt, pl, ho, wo, out_code, o_tile_first,
# o_tiles, stream), C a multiple of 16, channel tiles of 16, 32 or 64
INT8X_SIGNATURES = {"int8_conv": [_P] * 4 + [_I] * 14 + [_P]}
OLD_SIGNATURES = {"pr5": PR5_SIGNATURES, "noroot": NOROOT_SIGNATURES, "int8x": INT8X_SIGNATURES}


class SourceKernel(CudaKernel):
    """An entry point built from another source file."""

    def __init__(self, path: Path, name: str, entry: str, signature: list):
        super().__init__(name, entry, signature)
        self._path = path.resolve()

    @property
    def source(self) -> Path:
        return self._path


def warp_cases(dev):
    """Per pass: (label, shape, plain output in float32, output buffer,
    tolerance, bytes, operations, {abi: launch(kernel, out)})."""
    g = torch.Generator(device=dev).manual_seed(3)
    n, h, w, block = WARP_N, 736, 1280, 32
    img = torch.rand((n, h, w), generator=g, device=dev).to(torch.bfloat16)
    scale = 0.9 + 0.2 * torch.rand(n, generator=g, device=dev)
    for axis, label in ((2, "H"), (1, "V")):
        length = h if axis == 2 else w
        shear = 0.1 * torch.rand(n, generator=g, device=dev) - 0.05
        shift = 60.0 * torch.rand(n, generator=g, device=dev) - 30.0
        offsets = (shear[:, None] * torch.arange(length, device=dev)[None]
                   + shift[:, None]).contiguous()
        off_c = warp_ops.block_center_offsets(offsets, block)
        if axis == 2:
            ref = warp_ops.resample_last_axis_reference(img, scale, offsets, block, "bfloat16")
        else:
            ref = warp_ops.resample_last_axis_reference(
                img.transpose(1, 2), scale, offsets, block, "bfloat16").transpose(1, 2)
        wide = int(warp_ops.wide_path(img, block, axis))
        calls = {
            "current": lambda k, out, axis=axis, offsets=offsets, wide=wide: k.launch(
                img.data_ptr(), out.data_ptr(), scale.data_ptr(), offsets.data_ptr(),
                n, h, w, block, axis, 1, 1, wide, stream_handle(img)),
            "pr5": lambda k, out, axis=axis, off_c=off_c: k.launch(
                img.data_ptr(), out.data_ptr(), scale.data_ptr(), off_c.data_ptr(),
                n, h, w, block, off_c.shape[1], axis, 1, 1, stream_handle(img)),
        }
        nbytes = 2 * img.numel() * 2 + 4 * n * (off_c.shape[1] + 1)
        yield (f"warp_{label}", [n, h, w], ref.float(), torch.empty_like(img),
               WARP_BF16_TOL * ref.float().abs().max().item(), nbytes, 6 * img.numel(), calls)


def gem_cases(dev):
    """Per shape, as ``warp_cases``."""
    g = torch.Generator(device=dev).manual_seed(1)
    p = torch.tensor([3.0], device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, shape in (("gem_inference_tta_on", (2 * CHUNK * 5, 23, 40, 256)),
                         ("gem_inference_tta_off", (CHUNK * 5, 23, 40, 256)),
                         ("gem_train_head", (4, 23, 40, 1280))):
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        b, h, w, c = shape
        ref = gem_ops.gem_pool_reference(x, p)
        wide = gem_ops.wide_path(x)
        splits = gem_ops.gem_splits(b, h * w, c, 8 if wide else 1, sms)
        partial = torch.empty((splits, b, c), dtype=torch.float32, device=dev)
        calls = {
            "current": lambda k, out, x=x, b=b, h=h, w=w, c=c, wide=wide, splits=splits,
            partial=partial: k.launch(
                x.data_ptr(), p.data_ptr(), out.data_ptr(), partial.data_ptr(), b, h * w, c,
                1e-6, 1, int(wide), splits, 1, stream_handle(x)),
            "noroot": lambda k, out, x=x, b=b, h=h, w=w, c=c, wide=wide, splits=splits,
            partial=partial: k.launch(
                x.data_ptr(), p.data_ptr(), out.data_ptr(), partial.data_ptr(), b, h * w, c,
                1e-6, 1, int(wide), splits, stream_handle(x)),
            "pr5": lambda k, out, x=x, b=b, h=h, w=w, c=c: k.launch(
                x.data_ptr(), p.data_ptr(), out.data_ptr(), b, h * w, c, 1e-6, 1,
                stream_handle(x)),
        }
        nbytes = x.numel() * 2 + b * c * 4 + 4
        yield (label, list(shape), ref, torch.empty((b, c), dtype=torch.float32, device=dev),
               GEM_TOL * ref.abs().max().item(), nbytes, 5 * x.numel(), calls)


def int8x_launch(kernel, x_q, w_q, scale, stride, pads, out) -> None:
    """One call of an int8-input source (``--other-abi int8x``), sliced as
    its wrapper sliced the grid: 4 × 32-pixel tiles, channel tiles of 16, 32
    or 64, at most 2^31 − 1 blocks a launch."""
    n, h, w, c = x_q.shape
    o, k = w_q.shape[:2]
    ho, wo = out.shape[1:3]
    tiles = -(-ho // 4) * -(-wo // 32)
    per = max(1, (2**31 - 1) // tiles)
    o_tiles = -(-o // (16 if o <= 16 else 32 if o <= 32 else 64))
    for b0 in range(0, n, per):
        kernel.launch(x_q.data_ptr() + b0 * h * w * c, w_q.data_ptr(), scale.data_ptr(),
                      out.data_ptr() + b0 * ho * wo * o * out.element_size(), min(per, n - b0),
                      h, w, c, o, k, stride, pads[0], pads[2], ho, wo, 1, 0, o_tiles,
                      stream_handle(x_q))


def int8_main(other: CudaKernel, card: str) -> None:
    """``--kernel int8_conv`` (module docstring): one JSON line a shape."""
    dev = torch.device("cuda", 0)
    for i, (label, shape) in enumerate({**INT8_SHAPES, **INT8_MM_SHAPES}.items()):
        n, h, w, c, o, k, s = shape
        x, s_x, w_q, s_w, pads = int8_inputs(dev, shape, 40 + i)
        ho, wo = -(-h // s), -(-w // s)
        out = torch.empty((n, ho, wo, o), dtype=torch.bfloat16, device=dev)
        scale = s_x * s_w

        def old():
            int8x_launch(other, int8_ops.quantize(x, s_x), w_q, scale, s, pads, out)
            return out

        def int_mm_route():
            sums = torch._int_mm(int8_ops.quantize(x, s_x).reshape(-1, c), w_q.reshape(o, c).t())
            return int8_ops.dequantize(sums, scale, torch.bfloat16).reshape(n, ho, wo, o)

        versions = {"new": lambda: int8_ops.int8_conv2d(x, s_x, w_q, s_w, s, pads,
                                                        torch.bfloat16),
                    "other": old}
        if k == 1:
            versions["int_mm_route"] = int_mm_route
        row = {"case": label, "shape": list(shape), "dtype": "bfloat16", "card": card}
        for name, fn in versions.items():
            int8_exact(f"{label} {name}", fn(), x, s_x, w_q, s_w, s, pads)
            row[f"{name}_max_abs_diff"] = 0.0
        order = ["new", "other", "other", "new"]
        if k == 1:
            order = ["int_mm_route", *order, "int_mm_route"]
        times: dict[str, list[float]] = {name: [] for name in versions}
        for name in order:
            times[name].append(median_ms(versions[name]))
        row["ms"] = times
        nbytes = x.numel() * 2 + w_q.numel() + n * ho * wo * o * 2 + o * 4 + 4
        row["bound_ms"], row["bound_by"] = bound_int8(nbytes, 2 * n * ho * wo * o * k * k * c)
        print(json.dumps(row), flush=True)
        del x, out
        torch.cuda.empty_cache()


def int8_conv_main(kernels: dict, card: str) -> None:
    """``--kernel int8_conv --other-abi current`` (module docstring): one
    JSON line a shape."""
    dev = torch.device("cuda", 0)
    own, other = kernels.values()
    for i, (label, shape) in enumerate(INT8_SHAPES.items()):
        n, h, w, c, o, k, s = shape
        x, s_x, w_q, s_w, pads = int8_inputs(dev, shape, 40 + i)
        ho, wo = -(-h // s), -(-w // s)
        outs = {code: torch.empty((n, ho, wo, o), dtype=dtype, device=dev)
                for code, dtype in ((1, torch.bfloat16), (3, torch.int32))}

        def call(kernel, code=1):
            geometry = (n, h, w, c, o, s) if kernel is own else (n, h, w, c, o, k, s)
            kernel.launch(x.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
                          outs[code].data_ptr(), *geometry, pads[0], pads[2], ho, wo, 1, code,
                          stream_handle(x))
            return outs[code]

        row = {"case": label, "shape": list(shape), "dtype": "bfloat16", "card": card}
        for name, kernel in kernels.items():
            for code in (3, 1):
                int8_exact(f"{label} {name} out_code {code}", call(kernel, code), x, s_x, w_q,
                           s_w, s, pads)
            row[f"{name}_max_abs_diff"] = 0.0
        names = list(kernels)
        times: dict[str, list[float]] = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(device_ms_events(lambda: call(kernels[name]), kernels[name]))
        row["ms"] = times
        nbytes = x.numel() * 2 + w_q.numel() + n * ho * wo * o * 2 + o * 4 + 4
        row["bound_ms"], row["bound_by"] = bound_int8(nbytes, 2 * n * ho * wo * o * k * k * c)
        del x, outs
        torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(40 + i)
        xb = torch.randn((n, c, h, w), generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = torch.randn((o, c, k, k), generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        row["cudnn_bf16_ms"] = median_ms(lambda: F.conv2d(xb, wb, stride=s, padding=k // 2))
        print(json.dumps(row), flush=True)
        del xb, wb
        torch.cuda.empty_cache()


def int8_gemm_main(kernels: dict, card: str) -> None:
    """``--kernel int8_gemm`` (module docstring): one JSON line a shape."""
    dev = torch.device("cuda", 0)
    names = list(kernels)
    for i, (label, shape) in enumerate(INT8_MM_SHAPES.items()):
        n, h, w, c, o, _, _ = shape
        x, s_x, w_q, s_w, pads = int8_inputs(dev, shape, 40 + i)
        w2 = w_q.reshape(o, c)
        outs = {code: torch.empty((n, h, w, o), dtype=dtype, device=dev)
                for code, dtype in ((1, torch.bfloat16), (3, torch.int32))}

        def call(kernel, code=1):
            kernel.launch(x.data_ptr(), s_x.data_ptr(), w2.data_ptr(), s_w.data_ptr(),
                          outs[code].data_ptr(), n * h * w, c, o, 1, code, stream_handle(x))
            return outs[code]

        row = {"case": label, "shape": list(shape), "dtype": "bfloat16", "card": card}
        for name in names:
            for code in (3, 1):
                int8_exact(f"{label} {name} out_code {code}", call(kernels[name], code), x, s_x,
                           w_q, s_w, 1, pads)
            row[f"{name}_max_abs_diff"] = 0.0
        times: dict[str, list[float]] = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(device_ms_events(lambda: call(kernels[name]), kernels[name]))
        row["ms"] = times
        x_q, wt = int8_ops.quantize(x, s_x).reshape(-1, c), w2.t()
        row["int_mm_ms"] = median_ms(lambda: torch._int_mm(x_q, wt))
        nbytes = x.numel() * 2 + w_q.numel() + n * h * w * o * 2 + o * 4 + 4
        row["bound_ms"], row["bound_by"] = bound_int8(nbytes, 2 * n * h * w * o * c)
        print(json.dumps(row), flush=True)
        del x, x_q, outs
        torch.cuda.empty_cache()


def write_sass(kernels: dict, out_dir: Path) -> None:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, kernel in kernels.items():
        text = subprocess.run([cuobjdump, "-sass", str(kernel.library)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        (out_dir / f"{kernel.name}.sass").write_text(text)
        print(f"  [{name}] sass: {len(text.splitlines())} lines -> "
              f"{out_dir / (kernel.name + '.sass')}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("warp", "gem", "int8_conv", "int8_gemm"),
                        required=True)
    parser.add_argument("--other", type=Path, required=True,
                        help="another <kernel>.cu to build and time beside the repo's")
    parser.add_argument("--other-abi", choices=("current", "pr5", "noroot", "int8x"),
                        default="current",
                        help="the C interface of --other")
    parser.add_argument("--sass", type=Path, help="write cuobjdump -sass of both here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a GPU")
    card = card_line()
    print(card, flush=True)
    own = {"warp": warp_ops.KERNEL, "gem": gem_ops.KERNEL, "int8_conv": int8_ops.KERNEL,
           "int8_gemm": int8_ops.GEMM_KERNEL}[args.kernel]
    if args.other_abi != "current" and args.kernel not in OLD_SIGNATURES[args.other_abi]:
        parser.error(f"--other-abi {args.other_abi} does not apply to {args.kernel}")
    signature = (own.signature if args.other_abi == "current"
                 else OLD_SIGNATURES[args.other_abi][args.kernel])
    other = SourceKernel(args.other, f"{args.kernel}_other", own.entry, signature)
    if args.kernel == "int8_conv" and args.other_abi == "current":
        own = int8_ops.CONV3X3_KERNEL  # timed against the other int8_conv_forward
    kernels = {"kernel": own, args.other.name: other}
    abis = {"kernel": "current", args.other.name: args.other_abi}
    logs = build_all(list(kernels.values()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}", flush=True)
    if args.sass:
        write_sass(kernels, args.sass)

    if args.kernel == "int8_conv" and args.other_abi == "current":
        int8_conv_main(kernels, card)
        return 0
    if args.kernel == "int8_conv":
        int8_main(kernels[args.other.name], card)
        return 0
    if args.kernel == "int8_gemm":
        int8_gemm_main(kernels, card)
        return 0
    dev = torch.device("cuda", 0)
    cases = warp_cases(dev) if args.kernel == "warp" else gem_cases(dev)
    for label, shape, ref, out, tol, nbytes, flops, calls in cases:
        row = {"case": label, "shape": shape, "dtype": "bfloat16", "card": card,
               "tolerance": tol}
        for name, kernel in kernels.items():
            out.zero_()
            calls[abis[name]](kernel, out)
            err = (out.float() - ref).abs().max().item()
            row[f"{name}_max_abs_diff"] = err
            if not err <= tol:
                print(json.dumps(row), flush=True)
                raise SystemExit(f"{name} disagrees with the plain version: {err} > {tol}")
        order = list(kernels) + list(reversed(kernels))
        times: dict[str, list[float]] = {name: [] for name in kernels}
        match = "resample" if args.kernel == "warp" else "gem_"
        for name in order:
            times[name].append(device_ms(lambda: calls[abis[name]](kernels[name], out), match))
        row["device_ms"] = times
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        print(json.dumps(row), flush=True)
        del ref, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
