"""Golden CPU renderer — the framework's test oracle.

A direct, float32 NumPy implementation of the reference pipeline
(reference render/render.swift:229-344 == render-cpp/render.cpp:265-384):
camera-space transform, near-plane clip with triangle split, edge-function
scan-conversion with 1/z depth buffering, perspective-correct barycentric
interpolation, halfway-vector headlight shading, and flat-color or anisotropic
ripmap-textured coloring.

One deliberate difference from the reference: barycentric weights are evaluated in
closed form ``w(px, py) = w(0.5, 0.5) + px * dx + py * dy`` instead of incrementally
accumulated across the scan (render.swift:334-339). The device renderer uses the same
closed form, so golden <-> device comparisons are near-bit-exact; versus the
reference binary this only perturbs coverage on triangle-edge pixels by float
rounding.

Copy of ``swift3drenderer_tpu.golden.renderer`` (the same numpy code, so the
two give the same frame bit for bit), over the port's ``Scene``, config and
ripmap samplers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from ..utils.databin import Scene
from ..utils.ripmap import sample_ripmap, sample_ripmap_bilinear

f32 = np.float32


def edge_function(a, b, c):
    """Signed parallelogram area (reference render.swift:89-92).
    ``a``/``b`` are (..., 2+) vertices, ``c`` (..., 2+) query points."""
    return (c[..., 0] - a[..., 0]) * (a[..., 1] - b[..., 1]) + (
        c[..., 1] - a[..., 1]
    ) * (b[..., 0] - a[..., 0])


@dataclasses.dataclass
class TriJob:
    """Per-corner data for one triangle in flight (reference ``Data``,
    render.swift:58-65). All arrays are (3, k) float32, row = corner."""

    cv: np.ndarray    # camera-space positions (3, 3)
    rv: np.ndarray    # raster vertices: screen x, y, view depth (3, 3)
    attr: np.ndarray  # RGB color or (u, v, 0) (3, 3)
    n: np.ndarray     # camera-space normals (3, 3)
    tex: int          # texture index, -1 if flat color


def project(cv: np.ndarray, factor: f32, half_w: f32, half_h: f32) -> np.ndarray:
    """Camera space -> raster vertex (render.swift:251): screen xy via the pinhole
    ``(x, -y) * factor / -z`` plus screen center; rv.z stores the view depth -z."""
    z = -cv[..., 2]
    sx = cv[..., 0] * factor / z + half_w
    sy = -cv[..., 1] * factor / z + half_h
    return np.stack([sx, sy, z], axis=-1).astype(f32)


def clip_near(job: TriJob, near: f32, factor: f32, half_w: f32,
              half_h: f32) -> Tuple[TriJob, Optional[TriJob]]:
    """Near-plane clip of one straddling triangle (render.swift:177-227).

    Returns (modified primary, appended secondary or None). With one vertex in
    front the triangle shrinks in place; with two in front it becomes a quad:
    the primary keeps two original corners and the appended triangle completes it.
    Crossing points get their raster vertex recomputed at depth == near
    (render.swift:189) and attributes/normals lerped at
    ``a = (near - z_i) / (z_next - z_i)``.
    """
    front = job.rv[:, 2] > near
    s = next(i for i in range(3) if front[i] == front[(i + 1) % 3])
    new_triangle = bool(front[s])

    def crossing(i: int) -> TriJob:
        j = (i + 1) % 3
        a = f32((near - job.rv[i, 2]) / (job.rv[j, 2] - job.rv[i, 2]))
        cv = job.cv[i] * (1 - a) + job.cv[j] * a
        rv = np.array(
            [cv[0] * factor / near + half_w,
             -cv[1] * factor / near + half_h,
             near], dtype=f32)
        attr = job.attr[i] * (1 - a) + job.attr[j] * a
        n = job.n[i] * (1 - a) + job.n[j] * a
        return cv.astype(f32), rv, attr.astype(f32), n.astype(f32)

    nxt, prc = (s + 1) % 3, (s + 2) % 3
    x_next = crossing(nxt)   # crossing on edge (s+1 -> s+2)
    x_prec = crossing(prc)   # crossing on edge (s+2 -> s)

    def assemble(rows) -> TriJob:
        return TriJob(
            cv=np.stack([r[0] for r in rows]),
            rv=np.stack([r[1] for r in rows]),
            attr=np.stack([r[2] for r in rows]),
            n=np.stack([r[3] for r in rows]),
            tex=job.tex,
        )

    def orig(i: int):
        return job.cv[i], job.rv[i], job.attr[i], job.n[i]

    if new_triangle:
        # two in front (s, s+1): primary = [s, s+1, X(s+1,s+2)];
        # appended = [s, X(s+1,s+2), X(s+2,s)] (render.swift:202-222)
        rows = [orig(0), orig(1), orig(2)]
        rows[prc] = x_next
        primary = assemble(rows)
        appended = assemble([orig(s), x_next, x_prec])
        return primary, appended
    # one in front (s+2): shrink — [X(s+2,s), X(s+1,s+2), s+2] at the
    # original corner slots (render.swift:223-226)
    rows = [orig(0), orig(1), orig(2)]
    rows[s] = x_prec
    rows[nxt] = x_next
    return assemble(rows), None


def render_frame(
    scene: Scene,
    camera_matrix: np.ndarray,
    width: int,
    height: int,
    config: RenderConfig = DEFAULT_CONFIG,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one frame; returns (pixels (H, W) uint32, depth (H, W) float32).

    Depth holds 1/z with 0 = background (render.swift:27-30, cleared at 244)."""
    cfg = config
    near = f32(cfg.near)
    factor = f32(cfg.factor(height))
    half_w, half_h = f32(width) / 2, f32(height) / 2
    m = camera_matrix.astype(f32)  # (3, 4)

    pixels = np.full((height, width), cfg.background_packed, dtype=np.uint32)
    depth = np.zeros((height, width), dtype=f32)

    # Vertex stage (render.swift:248-252) and normal stage (253-255).
    cv_all = scene.vertices.astype(f32) @ m.T           # (V, 3)
    rv_all = project(cv_all, factor, half_w, half_h)     # (V, 3)
    n_all = scene.normals.astype(f32) @ m.T              # (A, 3)

    vi = scene.vertex_indices.reshape(-1, 3)
    ai = scene.attribute_indices.reshape(-1, 3)
    jobs: List[TriJob] = [
        TriJob(
            cv=cv_all[vi[t]],
            rv=rv_all[vi[t]],
            attr=scene.attr_vec[ai[t]].astype(f32),
            n=n_all[ai[t]],
            tex=int(scene.attr_tex[ai[t][0]]),
        )
        for t in range(vi.shape[0])
    ]

    idx = 0
    while idx < len(jobs):  # grows on clip splits, like render.swift:260
        job = jobs[idx]
        idx += 1
        rvz_corner = job.rv[:, 2]
        if rvz_corner.max() <= near:  # fully behind (render.swift:269)
            continue
        if rvz_corner.min() < near:   # straddles the near plane
            job, appended = clip_near(job, near, factor, half_w, half_h)
            if appended is not None:
                jobs.append(appended)
            rvz_corner = job.rv[:, 2]  # clip replaced corners

        rvmax = job.rv.max(axis=0)
        rvmin = job.rv.min(axis=0)
        if rvmax[0] < 0 or rvmax[1] < 0:               # render.swift:275
            continue
        if rvmin[0] >= width or rvmin[1] >= height:    # render.swift:277
            continue
        area = edge_function(job.rv[0], job.rv[1], job.rv[2])
        if area < cfg.min_area:  # small + backface cull (render.swift:280)
            continue
        one_over_area = f32(1.0) / f32(area)
        xmin = int(max(0.0, rvmin[0]))
        xmax = int(min(width - 1.0, rvmax[0]))
        ymin = int(max(0.0, rvmin[1]))
        ymax = int(min(height - 1.0, rvmax[1]))

        # Closed-form barycentric setup at the global pixel-(0,0) center.
        p00 = np.array([0.5, 0.5, 0.0], dtype=f32)
        w00 = np.array(
            [edge_function(job.rv[1], job.rv[2], p00),
             edge_function(job.rv[2], job.rv[0], p00),
             edge_function(job.rv[0], job.rv[1], p00)], dtype=f32) * one_over_area
        dx = np.array(
            [job.rv[1, 1] - job.rv[2, 1],
             job.rv[2, 1] - job.rv[0, 1],
             job.rv[0, 1] - job.rv[1, 1]], dtype=f32) * one_over_area
        dy = np.array(
            [job.rv[2, 0] - job.rv[1, 0],
             job.rv[0, 0] - job.rv[2, 0],
             job.rv[1, 0] - job.rv[0, 0]], dtype=f32) * one_over_area

        # Perspective premultiply (render.swift:297-299).
        rvz = (f32(1.0) / rvz_corner).astype(f32)            # (3,)
        cvp = job.cv * rvz[:, None]
        np_ = job.n * rvz[:, None]
        attrp = job.attr * rvz[:, None]

        px = np.arange(xmin, xmax + 1, dtype=f32)
        py = np.arange(ymin, ymax + 1, dtype=f32)
        # w[j, i, k] for pixel row j, col i, corner k
        w = (w00[None, None, :]
             + px[None, :, None] * dx[None, None, :]
             + py[:, None, None] * dy[None, None, :]).astype(f32)
        cover = (w >= 0).all(axis=-1)
        ooz = (w @ rvz).astype(f32)
        dwin = depth[ymin : ymax + 1, xmin : xmax + 1]
        visible = cover & (ooz > dwin)
        if not visible.any():
            continue

        wt = w / ooz[..., None]  # perspective-correct weights (render.swift:326)
        pt = -(wt @ cvp)
        pt = pt / np.linalg.norm(pt, axis=-1, keepdims=True)
        nrm = wt @ np_
        nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        halfway = pt + nrm
        halfway = halfway / np.linalg.norm(halfway, axis=-1, keepdims=True)
        shade = np.einsum("...k,...k->...", halfway, nrm).astype(f32)

        if job.tex >= 0:
            # Anisotropic level estimate (render.swift:305-316).
            uvp = attrp[:, :2]  # premultiplied uv
            dz = np.array([np.dot(rvz, dx), np.dot(rvz, dy)], dtype=f32)
            tpp = (uvp[0] * np.array([dx[0], dy[0]], dtype=f32)
                   + uvp[1] * np.array([dx[1], dy[1]], dtype=f32)
                   + uvp[2] * np.array([dx[2], dy[2]], dtype=f32))
            mapping = wt @ uvp  # (..., 2)
            with np.errstate(divide="ignore", invalid="ignore"):
                level = (ooz[..., None] / np.abs(tpp - mapping * dz)).astype(f32)
            sampler = (sample_ripmap_bilinear if cfg.sampling == "bilinear"
                       else sample_ripmap)
            color = sampler(scene.textures[job.tex], mapping, level)
        else:
            color = (wt @ attrp).astype(f32)

        shaded = shade[..., None] * color
        packed = (
            (shaded[..., 0].astype(np.uint32) << 16)
            | (shaded[..., 1].astype(np.uint32) << 8)
            | shaded[..., 2].astype(np.uint32)
        )
        pwin = pixels[ymin : ymax + 1, xmin : xmax + 1]
        pwin[visible] = packed[visible]
        dwin[visible] = ooz[visible]

    return pixels, depth
