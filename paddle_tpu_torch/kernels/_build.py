"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is one source with a plain C interface, which
may include headers of ``csrc/`` (``#include "<header>.cuh"``).  It
compiles on its own into ``build/lib<name>-<hash>.so``, where the hash
covers the source bytes, the bytes of the headers it includes and the
compiler flags, so an edited source or header rebuilds and an unchanged
one is reused.  ``build()``
starts one ``nvcc`` per missing library, all at once, and waits for all
of them; ``library(name)`` builds on first use and loads the result.
Nothing here runs at import time: the CPU tests import every module on
a host that has no ``nvcc``.

Pointers and the stream cross into C as ``ctypes.c_void_p``; every C
entry returns ``cudaGetLastError()`` after its launch, and the Python
wrapper raises :class:`KernelLaunchError` when that is not 0 (a refused
launch never runs, and a later synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "KernelBuildError", "KernelLaunchError",
           "SOURCES", "build", "check", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "conv_epilogue",
           "corpus")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a non-zero cudaError_t, kept in
    ``.code``."""

    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.code = code


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH) — the CUDA kernels build only on a host with the "
            "CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(path: Path, seen=None) -> bytes:
    """The bytes of ``path`` and of the ``csrc/`` headers it includes,
    transitively, each once."""
    seen = set() if seen is None else seen
    seen.add(path)
    data = path.read_bytes()
    for inc in _INCLUDE.findall(data):
        header = CSRC / inc.decode()
        if header not in seen:
            data += _source_bytes(header, seen)
    return data


def _target(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source whose library is missing, one nvcc
    process each, all started together.  Returns ``{name: {"seconds",
    "log"}}`` — ``log`` is nvcc's output (ptxas register and spill
    counts; empty for a library already built).  Raises
    :class:`KernelBuildError` naming every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        if so.is_file():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero cudaError_t."""
    if err:
        raise KernelLaunchError(
            f"{kernel}: launch failed with cudaError_t {err}", err)
