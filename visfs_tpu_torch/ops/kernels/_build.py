"""Build the port's native libraries at first use and load them by ctypes.

Each library is compiled from sources in the package (the CUDA kernels from
``visfs_tpu_torch/csrc/`` by ``nvcc``, the host runtime
``visfs_tpu_torch/runtime/runtime.cc`` by ``g++``) into
``build/visfs_tpu_torch/`` at the repository root (git-ignored), as a
shared library with a plain C interface.  The file name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as built.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "visfs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

# name -> (ctypes.CDLL, build log, build seconds); one per process.
_LOADED: dict = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of visfs_tpu_torch are built "
            "with the CUDA toolkit on the machine with the card")
    return nvcc


def _find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime of "
                           "visfs_tpu_torch is built with the host compiler")
    return gxx


# compiler -> (how to find it, its flags)
_TOOLCHAINS = {"nvcc": (_find_nvcc, NVCC_FLAGS), "g++": (_find_gxx, GXX_FLAGS)}


def load_library(name: str, sources: tuple, src_dir: Path = CSRC_DIR,
                 compiler: str = "nvcc") -> ctypes.CDLL:
    """Build (if needed) and load lib<name> from ``sources`` under
    ``src_dir`` with ``compiler`` ("nvcc" or "g++"); returns the ctypes
    handle."""
    if name in _LOADED:
        return _LOADED[name][0]
    find, flags = _TOOLCHAINS[compiler]
    paths = [Path(src_dir) / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log, seconds = "", 0.0
    if not out.exists():
        exe = find()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *flags, "-o", tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{compiler} failed ({proc.returncode}) "
                               f"building {name}:\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, log, seconds)
    return lib


def build_info(name: str):
    """(build log, build seconds) of a library loaded in this process; an
    empty log and 0 s mean it was loaded as already built."""
    _, log, seconds = _LOADED[name]
    return log, seconds
