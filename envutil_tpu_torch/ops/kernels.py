"""Build and load the port's hand-written CUDA kernels.

Each kernel source in ``csrc/`` has a plain C entry point. It is
compiled with nvcc for sm_90a into ``_build/`` (git-ignored) under a
name keyed on a hash of the source and of the headers beside it (the
device functions the kernels share), at first use, and loaded with
ctypes; PyTorch's headers stay out of the build, which keeps it to
seconds. ``build_all`` starts one nvcc per source together and waits
for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
# --split-compile 0: a source's kernels are optimised on all cores (the
# inline kernels have 96 instantiations of two branches each)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile", "0", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "port's CUDA kernels cannot be built")
    return path


class Library:
    """One compiled kernel source and its C entry points, ``symbols``
    mapping each name to its ctypes ``argtypes``; an entry point returns
    a CUDA error code (0 on success)."""

    def __init__(self, source: str, symbols: dict):
        self.source = _PKG / "csrc" / source
        self.symbols = symbols
        self.fns = {}
        self.build_log = ""
        self._lib = None
        self._proc = None

    def _so(self) -> pathlib.Path:
        text = self.source.read_bytes()
        for header in sorted(self.source.parent.glob("*.cuh")):
            text += header.read_bytes()
        digest = hashlib.sha256(text).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def start(self) -> None:
        """Start nvcc in the background unless the library is built."""
        if self._lib is not None or self._proc is not None \
                or self._so().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        self._proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", self._tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def _finish(self) -> None:
        proc, self._proc = self._proc, None
        try:
            self.build_log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{self.source.name}:\n{self.build_log}")
            os.replace(self._tmp, self._so())
        finally:
            if os.path.exists(self._tmp):
                os.unlink(self._tmp)

    def load(self) -> None:
        """Build the library if need be and load it."""
        if self._lib is None:
            self.start()
            if self._proc is not None:
                self._finish()
            self._lib = ctypes.CDLL(str(self._so()))

    def get(self, symbol: str):
        """The loaded entry point ``symbol``, built first if need be."""
        if symbol not in self.fns:
            self.load()
            fn = getattr(self._lib, symbol)
            fn.argtypes = self.symbols[symbol]
            fn.restype = ctypes.c_int
            self.fns[symbol] = fn
        return self.fns[symbol]


def build_all(libraries) -> float:
    """Build (in parallel) and load ``libraries``; returns the wall
    seconds this took (about 0 when all were built before)."""
    t0 = time.perf_counter()
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.load()
    return time.perf_counter() - t0
