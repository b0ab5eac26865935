"""Build and load the hand-written CUDA kernels of ``limap_tpu_torch/csrc``.

Each ``.cu`` file has a plain C interface.  It is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``limap_tpu_torch/_build/`` at first
use, loaded with ``ctypes``, and rebuilt when its source, a header of
``csrc`` or its flags change (the hash of all three names the library).
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source: kernel I's two designs inline the same residual
# and must round alike, so nothing there is contracted into an FMA (nvcc
# contracts by the inlining context)
SOURCE_FLAGS = {"lm_jointloc.cu": ("-fmad=false",)}

# per library: (seconds spent building in this process, ptxas report)
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of limap_tpu_torch "
                       "are built from source at first use")


@functools.lru_cache(maxsize=None)
def load_library(source: str, define: str = "") -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if its library is missing, then load it;
    with ``define`` the source's variant built with ``-D<define>`` (a
    library of its own, named after the macro)."""
    src = os.path.join(CSRC_DIR, source)
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(source, ()) + (
        (f"-D{define}",) if define else ())
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0] + (f"_{define.lower()}" if define
                                           else "")
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
        BUILD_INFO[stem] = (time.perf_counter() - t0, proc.stderr)
    return ctypes.CDLL(lib)


def check_tensor(name, t, dtype, shape, device) -> None:
    """A kernel wrapper's input check: ``t`` has the dtype, shape and
    device the kernel was written for."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: {dtype} {shape} on {device} expected, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
