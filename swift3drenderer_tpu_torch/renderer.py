"""Device renderer: the frame pipeline of ``swift3drenderer_tpu.renderer`` and
``ops.raster_pallas.render_frame_pallas`` / ``render_batch_pallas`` on
PyTorch.

  host: camera update (NumPy)  ->  (3, 4) matrix, or (B, 3, 4) batch, to the
        device
  device: the front-end in one launch (``ops.frontend.frontend_setup``:
  vertex + normal products, near-plane clip prepass, setup table)
  -> binning -> one raster kernel launch for the frame or the whole batch:
     raster_flat_{nearest,bilinear} for small scenes or
     raster_segmented_{nearest,bilinear} for large ones (visibility, shading,
     texel fetch) -> (B, H, W) packed pixels and 1/z depth

The scene is uploaded once, corner-major; per frame only the matrix goes to the
device. A single frame is the batch of one. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, which takes the plain PyTorch
version of every kernel. On the card ``Renderer`` replays one CUDA graph per
frame size and batch (``graphs.FrameGraphs``), the counterpart of the JAX
frame's one compile per size; ``render(..., bucketed=True)`` replays one per
resize bucket (``bucket_dims``) with the true size in device scalars
(``render_frames_bucketed``), so a drag-resize captures log-many times.

Two backends share the front-end (``BACKENDS``): ``"cuda"``, the
hand-written raster kernels (their plain versions on the CPU), and
``"xla"``, ``ops.raster_xla``, the JAX package's portable banded rasterizer
in torch ops (``render_frame_xla``), on the same device. The JAX
``Renderer`` defaults to its ``"xla"`` backend; the port's defaults to
``"cuda"``. ``Renderer(scene, backend="native")`` renders on the host
through the C++ core of ``native/`` instead (``native.NativeRenderer``), as
the JAX ``Renderer`` does; only a caller that names it gets it.

``render_range`` renders one triangle range of a frame with its winners'
global ids: the per-device pipeline of ``parallel.render_scene_sharded``.
It runs the front-end stage by stage (``build_corners``, ``clip_prepass``,
``triangle_setup``), the plain version's chain, on every device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, RenderConfig
from .convert import device_arrays_from_numpy, resolve_device
from .graphs import FrameGraphs
from .ops.clip import clip_prepass
from .ops.frontend import frontend_setup
from .ops import raster_xla
from .ops.raster import rasterize
from .ops.setup import triangle_setup
from .ops.vertex import project, transform_normals, transform_points
from .utils.databin import Scene

BACKENDS = ("cuda", "xla")
# The host backend: only ``Renderer`` takes it, never a device path.
NATIVE = "native"


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port renders with "
                         f"{' or '.join(BACKENDS)}")


def rasterize_backend(setup: Dict[str, torch.Tensor], textures: torch.Tensor,
                      *, width: int, height: int, config: RenderConfig,
                      backend: str, y_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch's setup tables (leading B) through the backend's rasterizer,
    rows [y_offset, y_offset + height): one launch for ``"cuda"``,
    ``raster_xla.rasterize`` frame by frame for ``"xla"`` (the JAX package
    vmaps it)."""
    if backend == "cuda":
        return rasterize(setup, textures, width=width, height=height,
                         background=config.background_packed,
                         sampling=config.sampling, y_offset=y_offset)
    check_backend(backend)
    frames = [raster_xla.rasterize(
        {k: v[b] for k, v in setup.items()}, textures, width=width,
        height=height, background=config.background_packed,
        y_offset=y_offset, sampling=config.sampling)
        for b in range(setup["live"].shape[0])]
    return tuple(torch.stack(p) for p in zip(*frames))


def scene_to_device(scene: Scene, device) -> Dict[str, torch.Tensor]:
    """Upload a host Scene in structure-of-arrays form, with the corner
    gathers (``vertices[vi]`` etc.) done once here, corner-major, as
    renderer.py:31-55 of the JAX package does."""
    vi = scene.vertex_indices.reshape(-1, 3).astype(np.int64)
    ai = scene.attribute_indices.reshape(-1, 3).astype(np.int64)
    verts = scene.vertices.astype(np.float32)
    norms = scene.normals.astype(np.float32)
    attrs = scene.attr_vec.astype(np.float32)
    return device_arrays_from_numpy(dict(
        textures=np.asarray(scene.textures, np.uint32),     # (NT, 512, 512)
        vert_c=verts[vi],                                   # (T, 3, 4)
        norm_c=norms[ai],                                   # (T, 3, 4)
        attr_c=attrs[ai],                                   # (T, 3, 3)
        tex_c=scene.attr_tex[ai[:, 0]],                     # (T,)
    ), device)


def build_corners(dev: Dict[str, torch.Tensor], m: torch.Tensor, *,
                  width: int, height: int, config: RenderConfig, lo: int = 0,
                  count: int | None = None) -> Dict[str, torch.Tensor]:
    """Stage A of the front-end for triangles [lo, lo + count) (all by
    default) under one camera ``m`` (3, 4): the vertex and normal transforms
    and the projection, before any clipping — (cv, rv, attr, n) (count, 3, 3)
    and tex (count,), the arguments of ``clip_prepass``. The range is cut
    before the transforms, which work per corner, so its values equal
    ``build_setup``'s stage A for the same triangles, bit for bit
    (``renderer.py::build_corners`` of the JAX package)."""
    factor = config.factor(height)
    t = dev["vert_c"].shape[0]
    hi = t if count is None else min(lo + count, t)
    lo = min(lo, hi)
    cv_c = transform_points(dev["vert_c"][lo:hi].reshape(-1, 4), m)
    rv_c = project(cv_c, factor, width / 2.0, height / 2.0)
    nrm_c = transform_normals(dev["norm_c"][lo:hi].reshape(-1, 4), m)
    n = hi - lo
    return dict(cv=cv_c.reshape(n, 3, 3), rv=rv_c.reshape(n, 3, 3),
                attr=dev["attr_c"][lo:hi], n=nrm_c.reshape(n, 3, 3),
                tex=dev["tex_c"][lo:hi])


def render_range(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, lo: int,
                 count: int, width: int, height: int,
                 config: RenderConfig = DEFAULT_CONFIG
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triangles [lo, lo + count) of the frame under ``m`` (3, 4), with
    their winners' global ids: (pixels (H, W) int32, 1/z (H, W) f32, gid
    (H, W) int32, NO_GID = 2**30 where nothing covers).

    The counterpart of ``_rasterize_corners_ids(gid_base=lo)``: stage A, the
    clip prepass and the setup table run on the range alone, slot gids are
    ``2 * (lo + t) + {0, 1}`` (global slot order, so they ascend with the
    range's slot order), and the range renders in one tracked pass. A range
    past the scene's last triangle is padded with dead triangles (all
    corners at rv = 0, behind the near plane), as the JAX package pads a
    device's range; a range wholly past it gives (background, 0, NO_GID).
    Merged with ``parallel.merge_depth_gid``, the ranges of a partition give
    ``render_frame``'s frame bit for bit: setup works per triangle, and the
    (max 1/z, then min gid) rule is the kernels' tie rule."""
    corners = build_corners(dev, m, width=width, height=height,
                            config=config, lo=lo, count=count)
    pad = count - corners["tex"].shape[0]
    if pad:
        corners = {k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
                   for k, v in corners.items()}
    factor = config.factor(height)
    setup = triangle_setup(
        clip_prepass(**corners, near=config.near, factor=factor,
                     half_w=width / 2.0, half_h=height / 2.0),
        width, height, config.min_area)
    tri = lo + torch.arange(count, dtype=torch.int32, device=m.device)
    gids = (2 * tri[:, None] + torch.arange(2, dtype=torch.int32,
                                            device=m.device)).reshape(-1)
    return rasterize(setup, dev["textures"], width=width, height=height,
                     background=config.background_packed,
                     sampling=config.sampling, gids=gids)


def build_setup(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, width,
                height, config: RenderConfig,
                proj=None) -> Dict[str, torch.Tensor]:
    """Geometry front-end: transforms, clip prepass, setup table, in one
    launch of ``ops.frontend.frontend_setup`` on the card (its plain
    version, the stage-by-stage chain, on the CPU).

    ``m`` is one (3, 4) matrix, or a (B, 3, 4) batch; then every setup array
    carries a leading B, and frame b's table equals ``build_setup`` of
    ``m[b]`` alone, key for key and bit for bit.

    ``width``/``height`` may be 0-dim float32 tensors on the device (the
    bucketed frame); then pass the projection constants as ``proj =
    (factor, half_w, half_h)``, 0-dim tensors from ``frame_dims``, so the
    table equals the exact-size one bit for bit."""
    if proj is None:
        factor = config.factor(height)
        half_w, half_h = width / 2.0, height / 2.0
    else:
        factor, half_w, half_h = proj
    return frontend_setup(dev["vert_c"], dev["norm_c"], dev["attr_c"],
                          dev["tex_c"], m, width=width, height=height,
                          factor=factor, half_w=half_w, half_h=half_h,
                          near=config.near, min_area=config.min_area)


def render_frames(dev: Dict[str, torch.Tensor], ms: torch.Tensor, *,
                  width: int, height: int, config: RenderConfig = DEFAULT_CONFIG,
                  backend: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of frames (ms (B, 3, 4)) through one front-end and one raster
    launch: (pixels (B, H, W) int32 holding 0x00RRGGBB, depth (B, H, W) f32),
    any scene size, with no device-to-host copy. Counterpart of
    ``render_batch_pallas``; frame b equals ``render_frame`` of ``ms[b]``.
    ``backend="xla"`` rasterizes each frame with ``ops.raster_xla``."""
    if ms.dim() != 3 or tuple(ms.shape[1:]) != (3, 4):
        raise ValueError(f"need a (B, 3, 4) batch of matrices, got {tuple(ms.shape)}")
    check_backend(backend)
    setup = build_setup(dev, ms, width=width, height=height, config=config)
    return rasterize_backend(setup, dev["textures"], width=width,
                             height=height, config=config, backend=backend)


def render_frame_xla(dev: Dict[str, torch.Tensor], m: torch.Tensor, *,
                     width: int, height: int,
                     config: RenderConfig = DEFAULT_CONFIG,
                     band_rows: int = 32, chunk: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame (m (3, 4)) through the front-end and ``ops.raster_xla``:
    (pixels (H, W) int32, depth (H, W) f32). Counterpart of the JAX
    ``render_frame_xla``; ``band_rows`` and ``chunk`` change no bit."""
    setup = build_setup(dev, m, width=width, height=height, config=config)
    return raster_xla.rasterize(
        setup, dev["textures"], width=width, height=height,
        background=config.background_packed, band_rows=band_rows,
        chunk=chunk, sampling=config.sampling)


def _bucket_dim(x: int, step: int, lo: int = 128, growth: float = 1.4) -> int:
    b = lo
    while b < x:
        b = -(-int(b * growth) // step) * step
    return b


def bucket_dims(width: int, height: int) -> Tuple[int, int]:
    """Geometric size buckets for live resize (the JAX package's
    ``bucket_dims``): a frame renders at the raster extent of its bucket and
    is cropped, so a drag-resize sweep captures at most log-many graphs."""
    return _bucket_dim(width, 128), _bucket_dim(height, 64)


def frame_dims(width: int, height: int,
               config: RenderConfig = DEFAULT_CONFIG) -> np.ndarray:
    """(5,) float32: width, height, factor, half_w, half_h — the true size
    and projection constants of a bucketed frame, computed on the host in
    float64 and rounded to float32 once, as the JAX ``Renderer`` builds its
    ``dims`` and as a Python float operand is rounded in the exact-size
    frame."""
    return np.array([width, height, config.factor(height), width / 2.0,
                     height / 2.0], np.float32)


def render_frames_bucketed(dev: Dict[str, torch.Tensor], ms: torch.Tensor,
                           dims: torch.Tensor, *, bw: int, bh: int,
                           config: RenderConfig = DEFAULT_CONFIG,
                           backend: str = "cuda"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of frames (ms (B, 3, 4)) of the true size in ``dims`` ((5,)
    float32 on the device, ``frame_dims``) rendered at the raster extent of
    its bucket (bw, bh) >= (W, H): (pixels (B, bh, bw) int32, depth (B, bh,
    bw) f32); the caller crops to ``[:, :H, :W]``. Counterpart of
    ``_render_frame_bucketed`` (its Pallas branch, or with ``backend="xla"``
    its XLA branch).

    The setup table is built with the true size, so every bbox ends inside
    it and columns and rows past it stay background; the tile grid and the
    bands start at 0, so each pixel inside the true size is the exact
    frame's. The crop equals ``render_frames`` at (W, H) bit for bit."""
    if ms.dim() != 3 or tuple(ms.shape[1:]) != (3, 4):
        raise ValueError(f"need a (B, 3, 4) batch of matrices, got {tuple(ms.shape)}")
    check_backend(backend)
    setup = build_setup(dev, ms, width=dims[0], height=dims[1], config=config,
                        proj=(dims[2], dims[3], dims[4]))
    return rasterize_backend(setup, dev["textures"], width=bw, height=bh,
                             config=config, backend=backend)


def render_frame(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, width: int,
                 height: int, config: RenderConfig = DEFAULT_CONFIG
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame: (pixels (H, W) int32 holding 0x00RRGGBB, depth (H, W) f32),
    the batch of one."""
    if tuple(m.shape) != (3, 4):
        raise ValueError(f"need a (3, 4) matrix, got {tuple(m.shape)}")
    pix, depth = render_frames(dev, m[None], width=width, height=height,
                               config=config)
    return pix[0], depth[0]


class Renderer:
    """Host-side frame orchestrator; the scene stays on ``device`` for the
    renderer's lifetime. ``backend`` picks the rasterizer on that device:
    ``"cuda"`` (the hand-written kernels; the default) or ``"xla"``
    (``ops.raster_xla``); the JAX ``Renderer``'s default is ``"xla"``.
    ``backend="native"`` renders on the host with the native C++ core
    (``native.NativeRenderer``, built at first use) whatever ``device``: the
    renderer holds no device tensors, ``render`` returns the core's frame,
    and ``render_device``, ``render_batch`` and ``update_scene`` raise.

    On the card every call replays a CUDA graph, captured at the first call
    of its key: (W, H, B), or with ``bucketed=True`` the bucket (bw, bh, B)
    — ``graphs`` holds them and counts captures and replays. What
    ``render_device`` and ``render_batch`` return is the caller's: a copy
    out of the graph's outputs, which the next call does not touch. On the
    CPU every call runs eagerly."""

    def __init__(self, scene: Scene, config: RenderConfig = DEFAULT_CONFIG,
                 device="cuda", backend: str = "cuda") -> None:
        scene.validate()
        self.config = config
        self.backend = backend
        if backend == NATIVE:
            from .native import NativeRenderer

            self._native = NativeRenderer(scene, config=config)
            self.device = self.dev = self.graphs = None
            return
        check_backend(backend)
        self.device = resolve_device(device)
        self.dev = scene_to_device(scene, self.device)
        # Host copies of the fixed topology, for update_scene.
        self._host_vi = scene.vertex_indices.reshape(-1, 3).astype(np.int64)
        self._host_ai = scene.attribute_indices.reshape(-1, 3).astype(np.int64)
        self._flat_shapes = {"vertices": scene.vertices.shape,
                             "normals": scene.normals.shape,
                             "attr_vec": scene.attr_vec.shape}
        self.graphs = (FrameGraphs(self.device) if self.device.type == "cuda"
                       else None)

    def _frames(self, ms: np.ndarray, width: int, height: int,
                bucketed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pixels (B, H, W), depth) of the poses ``ms`` (B, 3, 4): on the
        card, views of a graph's outputs, which its next replay overwrites."""
        b = ms.shape[0]
        inputs = ms.reshape(-1)
        if bucketed:
            bw, bh = bucket_dims(width, height)
            key = ("bucket", bw, bh, b)
            inputs = np.concatenate(
                [inputs, frame_dims(width, height, self.config)])

            def frame(x):
                return render_frames_bucketed(
                    self.dev, x[:12 * b].view(b, 3, 4), x[12 * b:], bw=bw,
                    bh=bh, config=self.config, backend=self.backend)
        else:
            key = ("exact", width, height, b)

            def frame(x):
                return render_frames(self.dev, x.view(b, 3, 4), width=width,
                                     height=height, config=self.config,
                                     backend=self.backend)
        if self.graphs is None:
            pix, depth = frame(torch.from_numpy(inputs))
        else:
            pix, depth = self.graphs.run(key, frame, inputs)
        return pix[:, :height, :width], depth[:, :height, :width]

    def _device_backend(self) -> None:
        if self.backend == NATIVE:
            raise ValueError("the native backend renders on host; use render()")

    def _owned(self, *planes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return planes if self.graphs is None else tuple(
            p.clone() for p in planes)

    def render_device(self, camera_matrix, width: int, height: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render, leaving (pixels (H, W) int32, depth (H, W) f32) on the
        device."""
        self._device_backend()
        m = np.asarray(camera_matrix, np.float32)
        if m.shape != (3, 4):
            raise ValueError(f"need a (3, 4) matrix, got {m.shape}")
        pix, depth = self._frames(m[None], width, height, False)
        return self._owned(pix[0], depth[0])

    def render(self, camera_matrix, width: int, height: int,
               bucketed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Render one frame; returns host (pixels (H, W) uint32, depth f32).

        ``bucketed=True`` renders at the size's ``bucket_dims`` bucket and
        crops: one graph per bucket instead of per exact size (live resize),
        the frame bit-equal to the exact-size one."""
        m = np.asarray(camera_matrix, np.float32)
        if m.shape != (3, 4):
            raise ValueError(f"need a (3, 4) matrix, got {m.shape}")
        if self.backend == NATIVE:
            return self._native.render(m, width, height)
        pix, depth = self._frames(m[None], width, height, bucketed)
        return pix[0].cpu().numpy().view(np.uint32), depth[0].cpu().numpy()

    def render_batch(self, matrices, width: int, height: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render a batch of camera poses ((B, 3, 4)) in one raster launch —
        the serving path (``Renderer.render_batch`` of the JAX package).
        Returns device tensors: pixels (B, H, W) int32, depth (B, H, W) f32."""
        self._device_backend()
        ms = np.asarray(matrices, np.float32)
        if ms.ndim != 3 or ms.shape[1:] != (3, 4):
            raise ValueError(f"need a (B, 3, 4) batch of matrices, got {ms.shape}")
        return self._owned(*self._frames(ms, width, height, False))

    def update_scene(self, vertices: Optional[np.ndarray] = None,
                     normals: Optional[np.ndarray] = None,
                     attr_vec: Optional[np.ndarray] = None) -> None:
        """Animate the scene: swap per-vertex/attribute data (the JAX
        ``Renderer.update_scene``). Shapes must match the bound scene; the
        topology and the textures are fixed per Renderer. The corner-major
        arrays are written in place, so every captured graph reads the new
        scene at its next replay."""
        if self.backend == NATIVE:
            raise ValueError("scene animation requires a device backend")
        for name, arr, cname, idx in (
                ("vertices", vertices, "vert_c", self._host_vi),
                ("normals", normals, "norm_c", self._host_ai),
                ("attr_vec", attr_vec, "attr_c", self._host_ai)):
            if arr is None:
                continue
            arr = np.asarray(arr, np.float32)
            if arr.shape != self._flat_shapes[name]:
                raise ValueError(
                    f"{name} shape {arr.shape} != bound "
                    f"{self._flat_shapes[name]}")
            self.dev[cname].copy_(torch.from_numpy(arr[idx]))
