"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and no PyTorch
headers, so one ``nvcc`` call builds it into a shared library in seconds.
Libraries go to ``_build/`` next to this file, named by a hash of the
sources and flags, so a rebuilt checkout never loads a stale library.
Nothing builds at import: a kernel is built at its first launch, or by
:func:`build_all` (one ``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit's default."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


class CudaKernel:
    """One C entry point of a ``.cu`` source: its library, its launch count.

    ``launches`` counts successful launches through :meth:`launch` (a plain
    integer; callers reset it to 0 to count one run).  ``ptxas_log`` holds
    the compiler's register / shared-memory / spill report of the build.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None

    @property
    def library(self) -> Path:
        """Path of this source's shared library (content-addressed)."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC.glob("*.cu*")):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    @property
    def ptxas_log(self) -> str:
        """``-Xptxas -v`` output saved beside the library by its build."""
        log = self.library.with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source; ``None`` when already built."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(self.source)]
        return subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        """Wait for a build started by :meth:`start_build`; raise on failure."""
        if proc is None:
            return
        out, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        self.library.with_suffix(".log").write_text(out)
        os.replace(tmp, self.library)

    def _entry(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.library))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = self._lib.mttkrp_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def query(self, *args) -> None:
        """Call the C entry point without counting a launch (an entry that
        launches nothing, such as an occupancy query); raise on a non-zero
        CUDA error code."""
        code = self._entry()(*args)
        if code != 0:
            msg = self._lib.mttkrp_error_string(code).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} ({msg})")

    def launch(self, *args) -> None:
        """Call the C entry point; raise on a non-zero CUDA error code."""
        self.query(*args)
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every kernel's library in parallel: one ``nvcc`` per source
    (entry points that share a source share its build)."""
    by_source = {k.source: k for k in kernels}
    procs = [(k, k.start_build()) for k in by_source.values()]
    for k, proc in procs:
        k.finish_build(proc)
