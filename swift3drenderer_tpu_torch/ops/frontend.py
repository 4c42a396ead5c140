"""The geometry front-end of a frame or a batch in one launch:
``frontend_setup``, the CUDA kernel of csrc/frontend.cu, and its plain
PyTorch version ``frontend_setup_plain``, the chain ``transform_points`` ->
``project`` -> ``transform_normals`` -> ``clip_prepass`` -> ``triangle_setup``
of ``ops.vertex``, ``ops.clip`` and ``ops.setup``.

Both give the setup table of ``ops.setup.triangle_setup`` over the 2T slots
of the clip prepass, with a leading batch axis where ``m`` has one, bit for
bit alike: the kernel does the plain version's float32 operations in its
order (csrc/frontend.cu says how). ``renderer.build_setup`` calls
``frontend_setup``: CPU tensors take the plain version, CUDA tensors launch
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from .. import kernels
from .clip import clip_prepass
from .raster import _check  # device, dtype, shape, contiguity
from .setup import triangle_setup
from .vertex import project, transform_normals, transform_points

Setup = Dict[str, torch.Tensor]

# The setup table's arrays, in the order of csrc/frontend.cu's outputs: each
# key's dtype and its shape past (..., 2T).
SETUP_KEYS = (
    ("live", torch.bool, ()), ("w00", torch.float32, (3,)),
    ("dx", torch.float32, (3,)), ("dy", torch.float32, (3,)),
    ("rvz", torch.float32, (3,)), ("cvp", torch.float32, (3, 3)),
    ("np", torch.float32, (3, 3)), ("attrp", torch.float32, (3, 3)),
    ("tex", torch.int32, ()), ("is_tex", torch.bool, ()),
    ("tpp", torch.float32, (2,)), ("dzv", torch.float32, (2,)),
    ("xmin", torch.int32, ()), ("xmax", torch.int32, ()),
    ("ymin", torch.int32, ()), ("ymax", torch.int32, ()),
)


def frontend_setup_plain(vert_c, norm_c, attr_c, tex_c, m, *, width, height,
                         factor, half_w, half_h, near: float,
                         min_area: float) -> Setup:
    """Plain PyTorch version of ``frontend_setup``. Only the vertex and
    normal products differ per frame; the frames are flattened frame-major
    into the triangle axis for the clip prepass and the setup table, which
    work per triangle and per slot, so each frame keeps its own slots in
    their own order (the order that decides depth ties)."""
    t = vert_c.shape[0]
    lead = tuple(m.shape[:-2])
    nb = math.prod(lead)
    cv_c = transform_points(vert_c.reshape(-1, 4), m)
    rv_c = project(cv_c, factor, half_w, half_h)
    nrm_c = transform_normals(norm_c.reshape(-1, 4), m)

    def per_frame(x):            # (..., T*3, 3) -> (B*T, 3, 3)
        return x.reshape(nb * t, 3, -1)

    def shared(x):               # (T, ...) -> (B*T, ...)
        return x.expand(nb, *x.shape).reshape(nb * t, *x.shape[1:])

    corners = clip_prepass(
        cv=per_frame(cv_c), rv=per_frame(rv_c), attr=shared(attr_c),
        n=per_frame(nrm_c), tex=shared(tex_c), near=near, factor=factor,
        half_w=half_w, half_h=half_h)
    setup = triangle_setup(corners, width, height, min_area)
    return {k: v.reshape(*lead, 2 * t, *v.shape[1:]) for k, v in setup.items()}


@functools.cache
def _entry():
    """The C entry point ``frontend_setup``: ten input pointers (five of
    them the device constants, each may be null), nine floats, sixteen
    output pointers, the frame and triangle counts, the stream."""
    fn = kernels.library(kernels.FRONTEND).frontend_setup
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_float] * 9
                   + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(vert_c, norm_c, attr_c, tex_c, m) -> None:
    dev = vert_c.device
    t = vert_c.shape[0] if vert_c.dim() else 0
    _check(vert_c, "vert_c", torch.float32, (t, 3, 4), dev)
    _check(norm_c, "norm_c", torch.float32, (t, 3, 4), dev)
    _check(attr_c, "attr_c", torch.float32, (t, 3, 3), dev)
    _check(tex_c, "tex_c", torch.int32, (t,), dev)
    if m.dim() not in (2, 3):
        raise ValueError(f"m: need (3, 4) or (B, 3, 4), got {tuple(m.shape)}")
    _check(m, "m", torch.float32, (*m.shape[:-2], 3, 4), dev)


def _dims_args(dims: dict, dev: torch.device):
    """The five constants as the C entry takes them, (pointers, values):
    all 0-dim float32 tensors on ``dev`` (their pointers, values 0), or all
    Python numbers (null pointers, the values, then width - 1 and height -
    1 as torch rounds them)."""
    tensors = [isinstance(v, torch.Tensor) for v in dims.values()]
    if all(tensors):
        for name, v in dims.items():
            _check(v, name, torch.float32, (), dev)
        return [v.data_ptr() for v in dims.values()], [0.0] * 7
    if any(tensors):
        raise ValueError(f"{', '.join(dims)}: need all Python numbers or "
                         "all 0-dim float32 tensors on the device")
    return ([None] * 5, [float(v) for v in dims.values()]
            + [float(dims["width"] - 1), float(dims["height"] - 1)])


def frontend_setup(vert_c: torch.Tensor, norm_c: torch.Tensor,
                   attr_c: torch.Tensor, tex_c: torch.Tensor, m: torch.Tensor,
                   *, width, height, factor, half_w, half_h, near: float,
                   min_area: float) -> Setup:
    """The setup table of the scene's corner arrays under one view matrix
    or a batch: the vertex and normal products, the projection, the
    near-plane clip prepass and the triangle setup (``triangle_setup``'s
    keys, with ``m``'s leading axis), in one launch.

    vert_c, norm_c (T, 3, 4) f32, attr_c (T, 3, 3) f32 and tex_c (T,) i32
    are ``renderer.scene_to_device``'s corner-major arrays; m is (3, 4) or
    (B, 3, 4) f32; all contiguous on one device. ``width``, ``height``,
    ``factor``, ``half_w`` and ``half_h`` are Python numbers (the
    exact-size frame) or, all five, 0-dim float32 tensors on the device
    (the bucketed frame, ``renderer.frame_dims``); the kernel reads those
    on the card, so the launch reads nothing back and captures in a CUDA
    graph. Returns arrays (..., 2T, ...): frame b's table equals that of
    ``m[b]`` alone.

    Every input is checked first, on either device. CPU tensors then take
    the plain version (``frontend_setup_plain``); CUDA tensors launch the
    kernel or raise. ``frontend_setup.launches`` counts the kernel's
    launches: each call that launches, eagerly or into a CUDA graph being
    captured (once, at capture; the graph's replays launch without the
    wrapper)."""
    _check_inputs(vert_c, norm_c, attr_c, tex_c, m)
    dims = dict(width=width, height=height, factor=factor, half_w=half_w,
                half_h=half_h)
    dev = vert_c.device
    dim_ptrs, dim_values = _dims_args(dims, dev)
    if dev.type == "cpu":
        return frontend_setup_plain(vert_c, norm_c, attr_c, tex_c, m,
                                    near=near, min_area=min_area, **dims)
    if dev.type != "cuda":
        raise ValueError(f"frontend_setup runs on cpu or cuda, not {dev}")
    lead = tuple(m.shape[:-2])
    frames, t = math.prod(lead), vert_c.shape[0]
    outs = {k: torch.empty((*lead, 2 * t, *shape), dtype=dtype, device=dev)
            for k, dtype, shape in SETUP_KEYS}
    if frames * t == 0:
        return outs
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _entry()(
            *(x.data_ptr() for x in (vert_c, norm_c, attr_c, tex_c, m)),
            *dim_ptrs, *dim_values, near, min_area,
            *(v.data_ptr() for v in outs.values()), frames, t,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("frontend_setup launch failed: "
                           + kernels.error_string(err, kernels.FRONTEND))
    frontend_setup.launches += 1
    return outs


frontend_setup.launches = 0
