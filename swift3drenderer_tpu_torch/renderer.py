"""Device renderer: the frame pipeline of ``swift3drenderer_tpu.renderer`` and
``ops.raster_pallas.render_frame_pallas`` / ``render_batch_pallas`` on
PyTorch.

  host: camera update (NumPy)  ->  (3, 4) matrix, or (B, 3, 4) batch, to the
        device
  device: vertex + normal products -> near-plane clip prepass -> setup table
  -> binning -> one raster kernel launch for the frame or the whole batch:
     raster_flat_{nearest,bilinear} for small scenes or
     raster_segmented_{nearest,bilinear} for large ones (visibility, shading,
     texel fetch) -> (B, H, W) packed pixels and 1/z depth

The scene is uploaded once, corner-major; per frame only the matrix goes to the
device. A single frame is the batch of one. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, which takes the plain PyTorch
version of every kernel.

``render_range`` renders one triangle range of a frame with its winners'
global ids: the per-device pipeline of ``parallel.render_scene_sharded``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, RenderConfig
from .convert import device_arrays_from_numpy, resolve_device
from .ops.clip import clip_prepass
from .ops.raster import rasterize
from .ops.setup import triangle_setup
from .ops.vertex import project, transform_normals, transform_points
from .utils.databin import Scene

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


def build_setup(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, width: int,
                height: int, config: RenderConfig) -> Dict[str, torch.Tensor]:
    """Geometry front-end: transforms, clip prepass, setup table.

    ``m`` is one (3, 4) matrix, or a (B, 3, 4) batch; then every setup array
    carries a leading B, and frame b's table equals ``build_setup`` of
    ``m[b]`` alone, key for key and bit for bit. Only the vertex and normal
    products differ per frame; the frames are flattened frame-major into the
    triangle axis for the clip prepass and the setup table, which work per
    triangle and per slot, so each frame keeps its own slots in their own
    order (the order that decides depth ties)."""
    factor = config.factor(height)
    half_w, half_h = width / 2.0, height / 2.0
    t = dev["vert_c"].shape[0]
    lead = tuple(m.shape[:-2])
    nb = math.prod(lead)
    cv_c = transform_points(dev["vert_c"].reshape(-1, 4), m)
    rv_c = project(cv_c, factor, half_w, half_h)
    nrm_c = transform_normals(dev["norm_c"].reshape(-1, 4), m)

    def per_frame(x):            # (..., T*3, 3) -> (B*T, 3, 3)
        return x.reshape(nb * t, 3, -1)

    def shared(x):               # (T, ...) -> (B*T, ...)
        return x.expand(nb, *x.shape).reshape(nb * t, *x.shape[1:])

    corners = clip_prepass(
        cv=per_frame(cv_c), rv=per_frame(rv_c), attr=shared(dev["attr_c"]),
        n=per_frame(nrm_c), tex=shared(dev["tex_c"]),
        near=config.near, factor=factor, half_w=half_w, half_h=half_h,
    )
    setup = triangle_setup(corners, width, height, config.min_area)
    return {k: v.reshape(*lead, 2 * t, *v.shape[1:]) for k, v in setup.items()}


def render_frames(dev: Dict[str, torch.Tensor], ms: torch.Tensor, *,
                  width: int, height: int, config: RenderConfig = DEFAULT_CONFIG
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of frames (ms (B, 3, 4)) through one front-end and one raster
    launch: (pixels (B, H, W) int32 holding 0x00RRGGBB, depth (B, H, W) f32),
    any scene size, with no device-to-host copy. Counterpart of
    ``render_batch_pallas``; frame b equals ``render_frame`` of ``ms[b]``."""
    if ms.dim() != 3 or tuple(ms.shape[1:]) != (3, 4):
        raise ValueError(f"need a (B, 3, 4) batch of matrices, got {tuple(ms.shape)}")
    setup = build_setup(dev, ms, width=width, height=height, config=config)
    return rasterize(setup, dev["textures"], width=width, height=height,
                     background=config.background_packed,
                     sampling=config.sampling)


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
    renderer's lifetime."""

    def __init__(self, scene: Scene, config: RenderConfig = DEFAULT_CONFIG,
                 device="cuda") -> None:
        scene.validate()
        self.config = config
        self.device = resolve_device(device)
        self.dev = scene_to_device(scene, self.device)

    def _matrices(self, matrices) -> torch.Tensor:
        return torch.as_tensor(np.asarray(matrices, np.float32),
                               device=self.device)

    def render_device(self, camera_matrix, width: int, height: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render, leaving (pixels (H, W) int32, depth (H, W) f32) on the
        device."""
        return render_frame(self.dev, self._matrices(camera_matrix),
                            width=width, height=height, config=self.config)

    def render(self, camera_matrix, width: int, height: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Render one frame; returns host (pixels (H, W) uint32, depth f32)."""
        pix, depth = self.render_device(camera_matrix, width, height)
        return pix.cpu().numpy().view(np.uint32), depth.cpu().numpy()

    def render_batch(self, matrices, width: int, height: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render a batch of camera poses ((B, 3, 4)) in one raster launch —
        the serving path (``Renderer.render_batch`` of the JAX package).
        Returns device tensors: pixels (B, H, W) int32, depth (B, H, W) f32."""
        return render_frames(self.dev, self._matrices(matrices), width=width,
                             height=height, config=self.config)
