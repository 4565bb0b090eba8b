"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles, at first use, into its own shared library
under ``build/`` at the repository root, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused. The
sources have a plain C interface (no PyTorch headers), which keeps a build
to seconds. All sources start compiling together.

``csrc/torch_ops.cpp``, the operator library that registers the fused-unit
kernels and eval-mode BatchNorm with PyTorch, compiles with ``g++`` against
the installed torch's headers and libraries (``build_ops``): the schemas
alone where torch has no CUDA, and the CUDA implementations too, linked
against the kernels' libraries, where it has.
Every build writes a temporary file of its own process and renames it over
the final name, so processes may race.

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

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_all", "build_ops", "compile_cxx", "load",
           "torch_link_flags"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

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


def torch_link_flags(with_cuda: bool) -> list[str]:
    """g++ flags to compile and link against the installed torch: its
    headers, its libraries (with a run-time search path to them) and its
    C++ ABI; with ``with_cuda`` also ``c10_cuda`` and ``torch_cuda``,
    linked even where no symbol of theirs is named, since loading them is
    what registers the CUDA backend."""
    import torch

    root = Path(torch.__file__).resolve().parent
    lib = root / "lib"
    include = root / "include"
    flags = [f"-I{include}", f"-I{include / 'torch' / 'csrc' / 'api' / 'include'}",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"-L{lib}", f"-Wl,-rpath,{lib}"]
    if with_cuda:
        flags += ["-Wl,--no-as-needed", "-lc10_cuda", "-ltorch_cuda", "-Wl,--as-needed"]
    return flags + ["-ltorch", "-ltorch_cpu", "-lc10"]


def compile_cxx(sources, out: Path, flags) -> Path:
    """``g++`` of ``sources`` into ``out`` through a temporary file of this
    process, renamed over ``out``; raises with the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *[str(s) for s in sources], *flags, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {out.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_ops() -> Path:
    """The operator library of ``csrc/torch_ops.cpp``, built if missing.

    Where torch was built with CUDA it carries the CUDA implementations
    (compiled with the toolkit's headers) and links against the kernels'
    libraries, built first if needed; elsewhere it holds the schemas
    alone. Named by a hash of the source, the flags
    (which name the kernels' libraries, themselves named by their sources'
    hashes) and the torch version."""
    import torch

    source = CSRC_DIR / "torch_ops.cpp"
    with_cuda = torch.version.cuda is not None
    flags = [*CXX_FLAGS, *torch_link_flags(with_cuda)]
    if with_cuda:
        kernels = [_library_path(CSRC_DIR / f"{stem}.cu") for stem in ("fused_bottleneck",
                                                                         "fused_bn")]
        if not all(k.exists() for k in kernels):
            build_all()
        cuda_include = Path(_nvcc()).resolve().parents[1] / "include"
        flags = ["-DIV2019_CUDA", f"-I{cuda_include}", *flags, *map(str, kernels),
                 f"-Wl,-rpath,{BUILD_DIR}"]
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()
                            + torch.__version__.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libtorch_ops_{digest}.so"
    if not lib.exists():
        compile_cxx([source], lib, flags)
    return lib
