"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``kernels/<pkg>/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a source builds in seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -I kernels/csrc -o <build>/<name>-<hash>.so \\
         <source>.cu

``kernels/csrc/`` holds the headers that kernels of several packages share
(``sm90.cuh``, Hopper's wgmma and copy helpers).  Libraries land in
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, the ``*.cuh`` headers of its own ``csrc/``
directory and of the shared one, and the flags, so an unchanged source is
never rebuilt and an edited header never loads a stale library.  Nothing
is compiled at import time: a library is built at the first launch of one
of its kernels, or all at once — one ``nvcc`` per source, started
together — by :func:`build_all`.

Every C entry point takes raw device pointers and PyTorch's current stream
as ``void*`` and returns ``cudaGetLastError()`` after its launch;
:class:`Kernel` raises on a non-zero code and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["Kernel", "Library", "build_all", "BUILD_DIR"]

_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "repro_torch"
#: headers shared by the kernels of several packages (``-I`` of every build)
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBRARIES: list["Library"] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the "
                           "port's CUDA kernels are built at first use")
    return str(path)


class Library:
    """One ``.cu`` source → one shared library, built on demand."""

    def __init__(self, name: str, source: Path):
        self.name = name
        self.source = Path(source)
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        #: ``nvcc`` output of the last build (``-Xptxas -v`` register and
        #: shared-memory report), empty when the library was cached.
        self.build_log = ""
        #: seconds from the start of the last build to its end (0.0 when
        #: the library was cached)
        self.build_s = 0.0
        self._started = 0.0
        _LIBRARIES.append(self)

    @property
    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        headers = {*self.source.parent.glob("*.cuh"),
                   *INCLUDE_DIR.glob("*.cuh")}
        for header in sorted(headers):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    def _command(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(out),
                str(self.source)]

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source (``None`` if already built)."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        self._started = time.perf_counter()
        return subprocess.Popen(self._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_s = time.perf_counter() - self._started
        self.build_log = out
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.path)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(self.path))
            return self._lib


class Kernel:
    """A C entry point of a :class:`Library` plus its launch counter.

    ``launches`` counts the calls of :meth:`launch` — the wrapper calls it
    exactly where the kernel runs, never on a plain (CPU) path.
    """

    def __init__(self, library: Library, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._count_lock = threading.Lock()

    def launch(self, *args) -> None:
        fn = getattr(self.library.load(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch "
                               f"(cudaError {err})")
        with self._count_lock:
            self.launches += 1


def build_all() -> list[Library]:
    """Build every declared library, one ``nvcc`` per source in parallel,
    then load each.  Returns the libraries (their ``build_log`` holds the
    compiler's register/shared-memory report)."""
    procs = [(lib, lib.start_build()) for lib in _LIBRARIES]
    errors = []
    for lib, proc in procs:
        try:
            lib.finish_build(proc)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in _LIBRARIES:
        lib.load()
    return list(_LIBRARIES)
