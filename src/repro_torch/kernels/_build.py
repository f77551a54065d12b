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


def _library(source: Path) -> Path:
    """Path of ``source``'s shared library (content-addressed: a hash of the
    flags and of every source)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def ptxas_log(source: Path) -> str:
    """``-Xptxas -v`` output (registers, shared memory, spills of each
    instance) saved beside ``source``'s library by its build."""
    log = _library(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start_build(source: Path) -> subprocess.Popen | None:
    """Start ``nvcc`` for ``source``; ``None`` when already built."""
    library = _library(source)
    if library.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(source: Path, proc: subprocess.Popen | None) -> None:
    """Wait for a build started by :func:`_start_build`; raise on failure."""
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name}:\n{out}")
    library = _library(source)
    library.with_suffix(".log").write_text(out)
    os.replace(tmp, library)


class CudaKernel:
    """One C entry point of the ``.cu`` sources, in each element type it is
    compiled for: its libraries and one launch count for them all.

    ``symbol`` is the float32 entry in ``source`` (its name ends in
    ``_f32``); ``variants`` maps the suffix of each other element type's
    entry (``bf16``, ``f16``, ``f64``: ``kernels._tiling.KERNEL_DTYPES``) to
    the source that holds it, named as ``symbol`` with that suffix in place
    of ``f32``.  Every entry of one kernel takes the same arguments.
    ``launches`` counts successful launches through :meth:`launch` in any
    element type (a plain integer; callers reset it to 0 to count one run).
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 variants: dict[str, str] | None = None):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        stem = symbol.removesuffix("f32")
        self.entries = {"f32": (self.source, symbol)}
        for suffix, src in (variants or {}).items():
            self.entries[suffix] = (CSRC / src, stem + suffix)
        self._fns = {}

    @property
    def sources(self) -> list[Path]:
        """Every source that holds an entry of this kernel."""
        return list(dict.fromkeys(src for src, _ in self.entries.values()))

    @property
    def ptxas_log(self) -> str:
        """``-Xptxas -v`` output of the float32 entry's build."""
        return ptxas_log(self.source)

    def _entry(self, suffix: str):
        fn = self._fns.get(suffix)
        if fn is None:
            source, symbol = self.entries[suffix]
            _finish_build(source, _start_build(source))
            lib = ctypes.CDLL(str(_library(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.mttkrp_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fns[suffix] = fn = (fn, err)
        return fn

    def query(self, *args, suffix: str = "f32") -> None:
        """Call the entry of element type ``suffix`` without counting a
        launch (an entry that launches nothing, such as an occupancy query);
        raise on a non-zero CUDA error code."""
        # (a built entry is looked up inline: a launch's host time sets how
        # fast back-to-back calls can follow each other)
        fn, err = self._fns.get(suffix) or self._entry(suffix)
        code = fn(*args)
        if code != 0:
            msg = err(code).decode()
            raise RuntimeError(f"{fn.__name__} failed: CUDA error {code} ({msg})")

    def launch(self, *args, suffix: str = "f32") -> None:
        """Call the entry of element type ``suffix``; raise on a non-zero
        CUDA error code."""
        self.query(*args, suffix=suffix)
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every library of the kernels, in each element type, in
    parallel: one ``nvcc`` per source (entry points that share a source
    share its build)."""
    sources = list(dict.fromkeys(src for k in kernels for src in k.sources))
    procs = [(src, _start_build(src)) for src in sources]
    for src, proc in procs:
        _finish_build(src, proc)
