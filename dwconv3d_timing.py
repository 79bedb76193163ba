"""Time the port's depthwise-3D kernel against other versions of its source,
on one NVIDIA GPU, at the flagship's inference shapes.

    git show <commit>:ball_action_spotting_torch/csrc/dwconv3d.cu > build/dwconv3d_base.cu
    python3 dwconv3d_timing.py --other build/dwconv3d_base.cu [--other another.cu ...]

Builds ``ball_action_spotting_torch/csrc/dwconv3d.cu`` and every ``--other``
source (each must export ``dwconv3d_forward`` with the same C interface)
with nvcc as ``ops/_cuda.py`` does, prints ptxas' register report, and holds
each against ``dwconv3d_reference`` (max|diff| ≤ 2⁻⁷·max|ref|, one bf16
rounding step, ``chip_smoke.DW_TOL``). Then, at (128, 5, 23, 40, 576) and
(256, 5, 23, 40, 576) bf16 (hflip TTA off and on), times them in turns,
forward and then backward through the list (A, B, B, A), each turn the
median of 10 CUDA-event runs. Prints the card's ``nvidia-smi`` name and power limit, and one
JSON line per shape with each source's two medians and its bound.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from ball_action_spotting_torch.ops import dwconv3d as dw
from ball_action_spotting_torch.ops._cuda import CudaKernel, build_all, stream_handle
from chip_smoke import CHUNK, DW_TOL, bound, card_line, median_ms

SHAPES = [(CHUNK, 5, 23, 40, 576), (2 * CHUNK, 5, 23, 40, 576)]


class SourceKernel(CudaKernel):
    """The depthwise-3D entry point built from another source file."""

    def __init__(self, path: Path, name: str):
        super().__init__(name, dw.KERNEL.entry, dw.KERNEL.signature)
        self._path = path.resolve()

    @property
    def source(self) -> Path:
        return self._path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[], type=Path,
                        help="another dwconv3d.cu to build and time beside the repo's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dwconv3d_timing needs a GPU")
    card = card_line()
    print(card, flush=True)
    kernels = {"kernel": dw.KERNEL}
    for i, path in enumerate(args.other):
        kernels[path.name] = SourceKernel(path, f"dwconv3d_other{i}")
    logs = build_all(list(kernels.values()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    for shape in SHAPES:
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        k = (torch.randn((3, 3, 3, 1, shape[-1]), generator=g, device=dev)
             / 27 ** 0.5).to(torch.bfloat16)
        taps = k.reshape(27, shape[-1]).float().contiguous()
        out = torch.empty_like(x)
        ref = dw.dwconv3d_reference(x, k).float()
        tol = DW_TOL * ref.abs().max().item()

        def run(kernel):
            kernel.launch(x.data_ptr(), taps.data_ptr(), out.data_ptr(), *shape, 1,
                          stream_handle(x))

        row = {"shape": list(shape), "dtype": "bfloat16", "card": card, "tolerance": tol}
        for name, kernel in kernels.items():
            out.zero_()
            run(kernel)
            err = (out.float() - ref).abs().max().item()
            row[f"{name}_max_abs_diff"] = err
            if not err <= tol:
                print(json.dumps(row), flush=True)
                raise SystemExit(f"{name} disagrees with the plain version: {err} > {tol}")
        del ref
        torch.cuda.empty_cache()
        order = list(kernels) + list(reversed(kernels))
        times: dict[str, list[float]] = {name: [] for name in kernels}
        for name in order:
            times[name].append(median_ms(lambda: run(kernels[name])))
        row["ms"] = times
        nbytes = 2 * x.numel() * 2 + 27 * shape[-1] * 2
        row["bound_ms"], row["bound_by"] = bound(nbytes, 54 * x.numel())
        print(json.dumps(row), flush=True)
        del x, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
