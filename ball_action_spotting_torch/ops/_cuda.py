"""The hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``
(``native.py``: the hashed library name, the build at first use or through
``build_all``, one ``nvcc`` per source, all at once).
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

from ball_action_spotting_torch.native import NativeLibrary, build_all

__all__ = ["CudaKernel", "NVCC_FLAGS", "build_all", "stream_handle"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaKernel(NativeLibrary):
    """One ``csrc/<name>.cu`` library: its build, its C entry point and the
    count of launches its wrapper made.

    ``signature`` lists the ctypes argument types of the entry point, which
    returns a ``cudaError_t`` (0 on success)."""

    suffix = ".cu"

    def __init__(self, name: str, entry: str, signature: list):
        super().__init__(name)
        self.entry = entry
        self.signature = signature
        self.launches = 0
        self.launches_by: dict[str, int] = {}
        self.launches_on: dict[str, int] = {}
        self._fn = None

    def compile_command(self, output: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(output), str(self.source)]

    def function(self):
        """The loaded C entry point, building the library first if needed."""
        if self._fn is None:
            fn = getattr(self.load(), self.entry)
            fn.argtypes = self.signature
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, tag: str | None = None) -> None:
        """Call the entry point on the current stream's work; raise on a
        nonzero ``cudaGetLastError``; count the launch, under ``tag`` in
        ``launches_by`` where the wrapper names one (a kernel with several
        modes, such as the warp's H and V passes), and under the current
        device (``cuda:i``, which the wrapper set to its input's) in
        ``launches_on``."""
        import torch

        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        self.launches += 1
        if tag is not None:
            self.launches_by[tag] = self.launches_by.get(tag, 0) + 1
        device = f"cuda:{torch.cuda.current_device()}"
        self.launches_on[device] = self.launches_on.get(device, 0) + 1

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by = {}
        self.launches_on = {}


def stream_handle(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
