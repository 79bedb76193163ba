"""Time the port's warp-resample or GeM kernel against another version of
its source, on one NVIDIA GPU, at the main paths' shapes.

    git show <commit>:ball_action_spotting_torch/csrc/warp.cu > build/warp_parent.cu
    python3 kernel_timing.py --kernel warp --other build/warp_parent.cu --other-abi pr5
    python3 kernel_timing.py --kernel gem --other build/gem_parent.cu --other-abi pr5

Builds ``ball_action_spotting_torch/csrc/<kernel>.cu`` and the ``--other``
source with nvcc as ``ops/_cuda.py`` does and prints ptxas' register
report. The other source exports the same entry point, with the repo's C
interface (``--other-abi current``) or that of PR 5's sources (``pr5``: the
warp took the block-center offsets gathered by the wrapper, GeM had no
16-byte or split mode). Each version is held against the plain PyTorch
version (``chip_smoke.py``'s tolerances), then the two are timed in turns,
A B B A, each turn the median over 10 calls of the kernel's own device time
(torch.profiler, ``chip_smoke.device_ms``). Shapes, bf16: warp H and V
passes at (60, 736, 1280); GeM at (1280, 23, 40, 256) and (640, 23, 40,
256) (inference, hflip TTA on and off) and (4, 23, 40, 1280) (train head).
Prints the card's ``nvidia-smi`` name and power limit first, then one JSON
line per shape with each version's two medians and the bound.
``--sass DIR`` also writes ``cuobjdump -sass`` of each built library there.
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

from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.ops import warp as warp_ops
from ball_action_spotting_torch.ops._cuda import CudaKernel, build_all, stream_handle
from chip_smoke import (
    CHUNK,
    GEM_TOL,
    WARP_BF16_TOL,
    WARP_N,
    bound,
    card_line,
    device_ms,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# PR 5's C interfaces (the repo's are the wrappers' KERNEL signatures):
# warp_resample(img, out, scale, off_c, n, h, w, block, nb, axis, dtype,
# bf16_math, stream), gem_forward(x, p, out, b, hw, c, eps, dtype, stream)
PR5_SIGNATURES = {
    "warp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "gem": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
}


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
                1e-6, 1, int(wide), splits, stream_handle(x)),
            "pr5": lambda k, out, x=x, b=b, h=h, w=w, c=c: k.launch(
                x.data_ptr(), p.data_ptr(), out.data_ptr(), b, h * w, c, 1e-6, 1,
                stream_handle(x)),
        }
        nbytes = x.numel() * 2 + b * c * 4 + 4
        yield (label, list(shape), ref, torch.empty((b, c), dtype=torch.float32, device=dev),
               GEM_TOL * ref.abs().max().item(), nbytes, 5 * x.numel(), calls)


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
    parser.add_argument("--kernel", choices=("warp", "gem"), required=True)
    parser.add_argument("--other", type=Path, required=True,
                        help="another <kernel>.cu to build and time beside the repo's")
    parser.add_argument("--other-abi", choices=("current", "pr5"), default="current",
                        help="the C interface of --other")
    parser.add_argument("--sass", type=Path, help="write cuobjdump -sass of both here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a GPU")
    card = card_line()
    print(card, flush=True)
    own = {"warp": warp_ops.KERNEL, "gem": gem_ops.KERNEL}[args.kernel]
    signature = own.signature if args.other_abi == "current" else PR5_SIGNATURES[args.kernel]
    kernels = {"kernel": own,
               args.other.name: SourceKernel(args.other, f"{args.kernel}_other", own.entry,
                                             signature)}
    abis = {"kernel": "current", args.other.name: args.other_abi}
    logs = build_all(list(kernels.values()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}", flush=True)
    if args.sass:
        write_sass(kernels, args.sass)

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
