"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
The build runs at first use (or up front through ``build_all``, which starts
one ``nvcc`` per source, all at once) into ``build/torch_kernels/`` beside
the package; the library name carries a hash of its source, so an edited
source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
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


class CudaKernel:
    """One ``csrc/<name>.cu`` library: its build, its C entry point and the
    count of launches its wrapper made.

    ``signature`` lists the ctypes argument types of the entry point, which
    returns a ``cudaError_t`` (0 on success)."""

    def __init__(self, name: str, entry: str, signature: list):
        self.name = name
        self.entry = entry
        self.signature = signature
        self.launches = 0
        self.launches_by: dict[str, int] = {}
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source unless its library exists."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path, proc.lib_path = tmp, lib  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(proc.tmp_path, proc.lib_path)  # type: ignore[attr-defined]

    def function(self):
        """The loaded C entry point, building the library first if needed."""
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.signature
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args, tag: str | None = None) -> None:
        """Call the entry point on the current stream's work; raise on a
        nonzero ``cudaGetLastError``; count the launch, and under ``tag``
        in ``launches_by`` where the wrapper names one (a kernel with
        several modes, such as the warp's H and V passes)."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        self.launches += 1
        if tag is not None:
            self.launches_by[tag] = self.launches_by.get(tag, 0) + 1

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by = {}


def build_all(kernels) -> dict[str, str]:
    """Build every kernel's library at once (one ``nvcc`` per source, all
    started together) and load them. Returns each kernel's build log."""
    procs = [(k, k.start_build()) for k in kernels]
    for k, proc in procs:
        k.finish_build(proc)
    for k in kernels:
        k.function()
    return {k.name: k.build_log for k in kernels}


def stream_handle(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
