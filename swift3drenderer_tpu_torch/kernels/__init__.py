"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is one library with a plain C interface (no
PyTorch headers, so nvcc takes seconds), compiled at first use into
``swift3drenderer_tpu_torch/_build/<stem>-<hash>.so`` (listed in .gitignore),
then loaded with ctypes. The hash covers the source and the flags, so an edit
rebuilds. A frame launches both ``raster.cu`` and ``frontend.cu``
(``FRAME``), so the first load of either starts both builds together. The
sources:

- ``raster.cu``: the four raster kernels, each with its winner-id tracking
  form (``library()``, the default);
- ``frontend.cu``: the front-end of a frame in one launch
  (``library("frontend.cu")``, ``ops.frontend.frontend_setup``);
- ``probes.cu``: the texel-fetch and chunk-loop probes of
  ``swift3drenderer_tpu_torch.tools`` (``library("probes.cu")``).

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
CSRC = os.path.join(_PKG, "csrc")
RASTER = "raster.cu"
FRONTEND = "frontend.cu"
PROBES = "probes.cu"
SOURCES = (RASTER, FRONTEND, PROBES)
FRAME = (FRONTEND, RASTER)
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
                           "CUDA kernels are built with the CUDA toolkit")
    return path


def library_path(source: str = RASTER) -> str:
    """Where the library of ``csrc/<source>`` is built."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def _start(source: str):
    """Start nvcc on ``csrc/<source>`` unless its library is current: (the
    process, the temporary output) or None."""
    so = library_path(source)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(source: str, started) -> str:
    if started is None:
        return ""
    proc, tmp = started
    out = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on csrc/{source}:\n{out}")
    # atomic: a concurrent loader sees all or none
    os.replace(tmp, library_path(source))
    return out


def build(source: str = RASTER) -> str:
    """Compile ``csrc/<source>`` unless its library is current. Returns
    nvcc's output (the ptxas register and spill report), empty if nothing was
    compiled."""
    return _finish(source, _start(source))


def build_all(sources=SOURCES) -> dict:
    """Compile every source of ``sources`` (by default all) that is not
    current, one nvcc each, all started together. Returns each source's nvcc
    output, as ``build``."""
    started = {s: _start(s) for s in sources}
    return {s: _finish(s, p) for s, p in started.items()}


@functools.cache
def library(source: str = RASTER) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed: by
    default ``raster.cu`` (``raster_flat_nearest``, ``raster_flat_bilinear``,
    ``raster_segmented_nearest``, ``raster_segmented_bilinear``). A source
    of ``FRAME`` is built together with the other."""
    if source in FRAME:
        build_all(FRAME)
    else:
        build(source)
    lib = ctypes.CDLL(library_path(source))
    lib.s3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.s3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int, source: str = RASTER) -> str:
    """CUDA's name for an error code a C entry point of ``csrc/<source>``
    returned."""
    return (f"CUDA error {code}: "
            + library(source).s3d_cuda_error_string(code).decode())
