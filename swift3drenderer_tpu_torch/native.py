"""ctypes bindings for the native host runtime, the C++ CPU core of
``native/`` (counterpart of ``swift3drenderer_tpu.native``).

The core is a twin of the device pipeline on the host: scene IO for the
data.bin format, the camera, and a CPU renderer (``native/src/*.cpp``, C ABI
in ``native/include/s3d_native.h``). ``Renderer(scene, backend="native")``
renders through it when the caller asks for it; nothing selects it by
itself.

The library is built at first use from the sources in the checkout with the
host C++ compiler (``$CXX``, else ``g++``) and the flags of
``native/Makefile``, into ``swift3drenderer_tpu_torch/_build/`` (listed in
.gitignore) under a name hashed over the sources, the flags, the compiler
and the host CPU: ``-march=native`` makes the library differ from machine to
machine, so each machine builds its own. Built from the same sources with the
same flags, it renders the JAX package's native frames bit for bit. A failed
build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes as C
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .utils.databin import Scene

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
SOURCES = ("src/scene_io.cpp", "src/camera.cpp", "src/raster.cpp")
HEADERS = ("include/s3d_native.h", "src/internal.h")
# native/Makefile's CXXFLAGS and LDFLAGS. -ffp-contract=off: no multiply-add
# is fused, so the core rounds as the f32 golden oracle does.
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-ffp-contract=off")
LDFLAGS = ("-shared", "-lm", "-lpthread")
BUILD_DIR = os.path.join(_PKG, "_build")


class S3DInput(C.Structure):
    _fields_ = [("up", C.c_float), ("down", C.c_float), ("left", C.c_float),
                ("right", C.c_float), ("mouse_x", C.c_float),
                ("mouse_y", C.c_float)]


class S3DFramebuffer(C.Structure):
    _fields_ = [("pixels", C.POINTER(C.c_uint32)),
                ("depth", C.POINTER(C.c_float)),
                ("width", C.c_uint32), ("height", C.c_uint32)]


class S3DConfig(C.Structure):
    _fields_ = [("near_plane", C.c_float), ("fov", C.c_float),
                ("speed", C.c_float), ("rotation_speed", C.c_float),
                ("min_area", C.c_float), ("background", C.c_uint32),
                ("bilinear", C.c_int)]


class S3DCamera(C.Structure):
    _fields_ = [("position", C.c_float * 3), ("axis_x", C.c_float * 3),
                ("axis_y", C.c_float * 3), ("axis_z", C.c_float * 3),
                ("mouse", C.c_float * 2), ("matrix", C.c_float * 12)]


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the native core "
                           "is built with the host compiler ($CXX, else g++)")
    return found


def _host_cpu() -> str:
    """The lines of /proc/cpuinfo that ``-march=native`` follows (the first
    CPU's model name and flags), where the file exists."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f if line.startswith(("model name",
                                                            "flags"))]
    except OSError:
        return ""
    return "".join(lines[:2])


def library_path() -> str:
    """Where this machine's library is built: the name hashes the sources,
    the headers, the flags, the compiler (its path and ``--version``) and
    the CPU that ``-march=native`` builds for."""
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    digest = hashlib.sha256(_host_cpu().encode())
    for rel in SOURCES + HEADERS:
        with open(os.path.join(NATIVE_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    digest.update(" ".join((cxx, version, *CXXFLAGS, *LDFLAGS)).encode())
    return os.path.join(BUILD_DIR, f"libs3dnative-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the native core unless this machine's library is current;
    returns the compiler's output (empty if nothing was compiled). Raises
    RuntimeError with that output if the compiler fails."""
    so = library_path()
    if os.path.exists(so):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    run = subprocess.run(
        [_compiler(), *CXXFLAGS,
         *(os.path.join(NATIVE_DIR, src) for src in SOURCES), "-o", tmp,
         *LDFLAGS], capture_output=True, text=True)
    out = run.stdout + run.stderr
    if run.returncode:
        raise RuntimeError(f"building the native core failed:\n{out}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    return out


@functools.cache
def load_native() -> C.CDLL:
    """The loaded native library, built first if needed, with every
    function's signature set."""
    build()
    lib = C.CDLL(library_path())
    lib.s3d_scene_load.restype = C.c_void_p
    lib.s3d_scene_load.argtypes = [C.c_char_p]
    lib.s3d_scene_from_memory.restype = C.c_void_p
    lib.s3d_scene_from_memory.argtypes = [C.c_char_p, C.c_size_t]
    lib.s3d_scene_create.restype = C.c_void_p
    lib.s3d_scene_create.argtypes = [
        C.POINTER(C.c_float), C.c_int64,
        C.POINTER(C.c_int64), C.c_int64,
        C.POINTER(C.c_float), C.POINTER(C.c_float), C.POINTER(C.c_int64),
        C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_uint32), C.c_int64]
    lib.s3d_scene_save.restype = C.c_int
    lib.s3d_scene_save.argtypes = [C.c_void_p, C.c_char_p]
    lib.s3d_scene_free.argtypes = [C.c_void_p]
    for fn in ("s3d_scene_vertex_count", "s3d_scene_triangle_count",
               "s3d_scene_texture_count"):
        getattr(lib, fn).restype = C.c_int64
        getattr(lib, fn).argtypes = [C.c_void_p]
    lib.s3d_last_error.restype = C.c_char_p
    lib.s3d_renderer_create.restype = C.c_void_p
    lib.s3d_renderer_create.argtypes = [C.c_void_p]
    lib.s3d_renderer_free.argtypes = [C.c_void_p]
    lib.s3d_render.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                               C.POINTER(S3DConfig), C.POINTER(S3DFramebuffer)]
    lib.s3d_config_default.argtypes = [C.POINTER(S3DConfig)]
    lib.s3d_camera_init.argtypes = [C.POINTER(S3DCamera)]
    lib.s3d_camera_update.argtypes = [C.POINTER(S3DCamera), C.POINTER(S3DInput),
                                      C.POINTER(S3DConfig), C.c_int]
    lib.s3d_now.restype = C.c_double
    return lib


def native_available() -> bool:
    """Whether the native core builds and loads on this machine."""
    try:
        load_native()
        return True
    except (OSError, RuntimeError):
        return False


def _config_struct(config: RenderConfig) -> S3DConfig:
    c = S3DConfig()
    load_native().s3d_config_default(C.byref(c))
    c.near_plane = config.near
    c.fov = config.fov
    c.speed = config.speed
    c.rotation_speed = config.rotation_speed
    c.min_area = config.min_area
    c.background = config.background_packed
    c.bilinear = 1 if config.sampling == "bilinear" else 0
    return c


class NativeRenderer:
    """CPU renderer backed by the native library, with ``Renderer.render``'s
    signature: host (pixels (H, W) uint32, depth (H, W) f32)."""

    def __init__(self, scene: Scene, config: RenderConfig = DEFAULT_CONFIG) -> None:
        lib = load_native()
        self._lib = lib
        self.config = config
        v = np.ascontiguousarray(scene.vertices, np.float32)
        vi = np.ascontiguousarray(scene.vertex_indices, np.int64)
        n = np.ascontiguousarray(scene.normals, np.float32)
        av = np.ascontiguousarray(scene.attr_vec, np.float32)
        at = np.ascontiguousarray(scene.attr_tex, np.int64)
        ai = np.ascontiguousarray(scene.attribute_indices, np.int64)
        tx = np.ascontiguousarray(scene.textures, np.uint32)
        self._scene = lib.s3d_scene_create(
            v.ctypes.data_as(C.POINTER(C.c_float)), scene.num_vertices,
            vi.ctypes.data_as(C.POINTER(C.c_int64)), vi.shape[0],
            n.ctypes.data_as(C.POINTER(C.c_float)),
            av.ctypes.data_as(C.POINTER(C.c_float)),
            at.ctypes.data_as(C.POINTER(C.c_int64)), scene.num_attributes,
            ai.ctypes.data_as(C.POINTER(C.c_int64)),
            tx.ctypes.data_as(C.POINTER(C.c_uint32)), scene.num_textures)
        if not self._scene:
            raise ValueError(lib.s3d_last_error().decode())
        self._renderer = lib.s3d_renderer_create(self._scene)

    def render(self, camera_matrix: np.ndarray, width: int,
               height: int) -> Tuple[np.ndarray, np.ndarray]:
        pixels = np.empty((height, width), np.uint32)
        depth = np.zeros((height, width), np.float32)
        fb = S3DFramebuffer(
            pixels.ctypes.data_as(C.POINTER(C.c_uint32)),
            depth.ctypes.data_as(C.POINTER(C.c_float)), width, height)
        m = np.ascontiguousarray(camera_matrix, np.float32).reshape(12)
        cfg = _config_struct(self.config)
        self._lib.s3d_render(self._renderer,
                             m.ctypes.data_as(C.POINTER(C.c_float)),
                             C.byref(cfg), C.byref(fb))
        return pixels, depth

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "_renderer", None):
            lib.s3d_renderer_free(self._renderer)
        if getattr(self, "_scene", None):
            lib.s3d_scene_free(self._scene)


def load_scene_native(path: str) -> int:
    """Load a data.bin through the native parser; returns the opaque handle
    (free it with ``load_native().s3d_scene_free``). Raises ValueError with
    the native error message on malformed input."""
    lib = load_native()
    handle = lib.s3d_scene_load(path.encode())
    if not handle:
        raise ValueError(lib.s3d_last_error().decode())
    return handle


class NativeCamera:
    """Camera driven by the native library (twin of ``camera.Camera``)."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG) -> None:
        self._lib = load_native()
        self._cfg = _config_struct(config)
        self._cam = S3DCamera()
        self._lib.s3d_camera_init(C.byref(self._cam))

    def update(self, up=0.0, down=0.0, left=0.0, right=0.0,
               mouse=(0.0, 0.0), force_update: bool = False) -> np.ndarray:
        inp = S3DInput(up, down, left, right, mouse[0], mouse[1])
        self._lib.s3d_camera_update(C.byref(self._cam), C.byref(inp),
                                    C.byref(self._cfg), 1 if force_update else 0)
        return np.array(self._cam.matrix, np.float32).reshape(3, 4)
