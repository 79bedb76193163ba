"""Build and load the port's native libraries from ``csrc/``: the CUDA
kernels (``ops/_cuda.py``, nvcc for ``sm_90a``) and the gray store's host
gather (``data/gray_store.py``, g++).

Each source is compiled into its own shared library with a plain C
interface, loaded with ``ctypes``, under ``build/torch_kernels/`` beside the
package. The library's name carries a hash of its source and of the local
headers it includes (``#include "..."``, followed recursively;
``lib<name>-<hash>.so``), so an edited source or header is rebuilt and a
stale library is never loaded. The compiler writes to a name of its own process
(``.<pid>.tmp``), renamed into place when it is done, so several processes
that build one source at once (test workers) never load a half-written
file. The build runs at first use, or up front through ``build_all``, which
starts one compiler per source, all at once, and records each one's seconds
(``build_seconds``). A failed build raises with the compiler's output:
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list[Path]:
    """``source`` and the local headers it includes (``#include "..."``,
    relative to the including file), each once, in the order met."""
    files, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / name.decode() for name in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return files


class NativeLibrary:
    """One ``csrc/<name><suffix>`` source and the library built from it."""

    suffix = ".cpp"

    def __init__(self, name: str):
        self.name = name
        self.build_log = ""
        self.build_seconds: float | None = None  # the last build's, None if none ran
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}{self.suffix}"

    @property
    def library(self) -> Path:
        digest = hashlib.sha256()
        for path in source_files(self.source):
            digest.update(path.read_bytes())
        digest = digest.hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def compile_command(self, output: Path) -> list[str]:
        raise NotImplementedError

    def start_build(self) -> subprocess.Popen | None:
        """Start the compiler for this source unless its library exists."""
        lib = self.library
        if lib.exists():
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = self.compile_command(tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        except OSError as exc:
            raise RuntimeError(f"cannot run {cmd[0]} to build {self.source}: {exc}") from exc
        proc.tmp_path, proc.lib_path = tmp, lib  # type: ignore[attr-defined]
        proc.started = time.perf_counter()  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - proc.started  # type: ignore[attr-defined]
        self.build_log = out
        if proc.returncode != 0:
            Path(proc.tmp_path).unlink(missing_ok=True)  # type: ignore[attr-defined]
            raise RuntimeError(f"{proc.args[0]} failed to build {self.source}:\n{out}")
        os.replace(proc.tmp_path, proc.lib_path)  # type: ignore[attr-defined]

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(self.library))
            return self._lib


class HostLibrary(NativeLibrary):
    """A C++ source for the host, built with g++."""

    FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

    def compile_command(self, output: Path) -> list[str]:
        return ["g++", *self.FLAGS, "-o", str(output), str(self.source), "-lpthread"]


def build_all(libraries) -> dict[str, str]:
    """Build every library at once (one compiler per source, all started
    together) and load them. Returns each library's build log."""
    procs = [(lib, lib.start_build()) for lib in libraries]
    errors = []

    def finish(lib, proc):  # each compiler waited for in its own thread
        try:
            lib.finish_build(proc)
        except RuntimeError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=finish, args=pair) for pair in procs]
    for t in threads:
        t.start()
    for t in threads:  # every compiler finishes before a failure is raised
        t.join()
    if errors:
        raise errors[0]
    for lib in libraries:
        lib.load()
    return {lib.name: lib.build_log for lib in libraries}
