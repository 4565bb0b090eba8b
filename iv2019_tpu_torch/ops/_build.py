"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles, at first use, into its own shared library
under ``build/`` at the repository root, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused. The
sources have a plain C interface (no PyTorch headers), which keeps a build
to seconds. All sources start compiling together.

Nothing here runs when the module is imported: the CPU test environment has
no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all at once.

    Returns {source stem: compiler output} for the sources built by this
    call (the ``-Xptxas -v`` register and shared-memory report). Raises
    with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in sorted(CSRC_DIR.glob("*.cu")):
        lib = _library_path(source)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[source.stem] = (proc, tmp, lib)
    reports, failed = {}, []
    for stem, (proc, tmp, lib) in jobs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{output}")
            continue
        os.replace(tmp, lib)
        reports[stem] = output
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    if stem not in _loaded:
        lib_path = _library_path(CSRC_DIR / f"{stem}.cu")
        if not lib_path.exists():
            build_all()
        _loaded[stem] = ctypes.CDLL(str(lib_path))
    return _loaded[stem]
