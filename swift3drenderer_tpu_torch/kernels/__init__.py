"""Build and load the port's hand-written CUDA kernels.

``csrc/raster.cu`` holds the four raster kernels, each with its winner-id
tracking form, behind a plain C interface (no PyTorch headers, so nvcc takes
seconds) and is compiled at first use into
``swift3drenderer_tpu_torch/_build/raster-<hash>.so`` (listed in .gitignore),
then loaded with ctypes. The hash covers the source and the flags, so an edit
rebuilds.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` so that no multiply-add is
contracted and the kernel rounds every operation as the plain PyTorch version
does; no ``--use_fast_math``, so division and square root stay IEEE-exact
(``-prec-div=true -prec-sqrt=true`` are nvcc's defaults).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "raster.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernel is built with the CUDA toolkit")
    return path


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"raster-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/raster.cu unless its library is current. Returns nvcc's
    output (the ptxas register and spill report), empty if nothing was
    compiled."""
    so = library_path()
    if os.path.exists(so):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on csrc/raster.cu:\n{proc.stdout}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    return proc.stdout


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library of ``csrc/raster.cu`` (``raster_flat_nearest``,
    ``raster_flat_bilinear``, ``raster_segmented_nearest``,
    ``raster_segmented_bilinear``), built first if needed."""
    build()
    lib = ctypes.CDLL(library_path())
    lib.s3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.s3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    """CUDA's name for an error code the kernel's C entry point returned."""
    return (f"CUDA error {code}: "
            + library().s3d_cuda_error_string(code).decode())
