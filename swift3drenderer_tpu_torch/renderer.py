"""Device renderer: the frame pipeline of ``swift3drenderer_tpu.renderer`` and
``ops.raster_pallas.render_frame_pallas`` on PyTorch.

  host: camera update (NumPy)  ->  (3, 4) matrix to the device
  device: vertex + normal products -> near-plane clip prepass -> setup table
  -> binning -> one raster kernel launch, raster_flat_nearest for small
     scenes or raster_segmented_nearest for large ones (visibility,
     shading, texel fetch) -> (H, W) packed pixels and 1/z depth

The scene is uploaded once, corner-major; per frame only the matrix goes to the
device. Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which takes the plain PyTorch version of every kernel.
"""

from __future__ import annotations

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


def build_setup(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, width: int,
                height: int, config: RenderConfig) -> Dict[str, torch.Tensor]:
    """Geometry front-end: transforms, clip prepass, setup table."""
    factor = config.factor(height)
    half_w, half_h = width / 2.0, height / 2.0
    t = dev["vert_c"].shape[0]
    cv_c = transform_points(dev["vert_c"].reshape(-1, 4), m)
    rv_c = project(cv_c, factor, half_w, half_h)
    nrm_c = transform_normals(dev["norm_c"].reshape(-1, 4), m)
    corners = clip_prepass(
        cv=cv_c.reshape(t, 3, -1), rv=rv_c.reshape(t, 3, -1),
        attr=dev["attr_c"], n=nrm_c.reshape(t, 3, -1), tex=dev["tex_c"],
        near=config.near, factor=factor, half_w=half_w, half_h=half_h,
    )
    return triangle_setup(corners, width, height, config.min_area)


def render_frame(dev: Dict[str, torch.Tensor], m: torch.Tensor, *, width: int,
                 height: int, config: RenderConfig = DEFAULT_CONFIG
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame: (pixels (H, W) int32 holding 0x00RRGGBB, depth (H, W) f32),
    any scene size in one raster pass, with no device-to-host copy."""
    if config.sampling != "nearest":
        raise NotImplementedError(
            f"sampling={config.sampling!r}: the port samples nearest only; "
            "bilinear waits for ROADMAP queue 1 item 9")
    setup = build_setup(dev, m, width=width, height=height, config=config)
    return rasterize(setup, dev["textures"], width=width, height=height,
                     background=config.background_packed)


class Renderer:
    """Host-side frame orchestrator; the scene stays on ``device`` for the
    renderer's lifetime."""

    def __init__(self, scene: Scene, config: RenderConfig = DEFAULT_CONFIG,
                 device="cuda") -> None:
        scene.validate()
        self.config = config
        self.device = resolve_device(device)
        self.dev = scene_to_device(scene, self.device)

    def render_device(self, camera_matrix, width: int, height: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render, leaving (pixels (H, W) int32, depth (H, W) f32) on the
        device."""
        m = torch.as_tensor(np.asarray(camera_matrix, np.float32),
                            device=self.device)
        return render_frame(self.dev, m, width=width, height=height,
                            config=self.config)

    def render(self, camera_matrix, width: int, height: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Render one frame; returns host (pixels (H, W) uint32, depth f32)."""
        pix, depth = self.render_device(camera_matrix, width, height)
        return pix.cpu().numpy().view(np.uint32), depth.cpu().numpy()
