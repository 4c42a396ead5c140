"""Wavefront OBJ import — a framework extension beyond the reference's built-in
primitives: load arbitrary triangle meshes into the Scene format (and therefore
into data.bin, the golden oracle and both of the port's backends).

Supported subset: ``v`` positions, ``vn`` normals, ``vt`` texcoords, ``f`` faces
with any of the index forms (``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``; negative
indices allowed), polygon faces (fan-triangulated), ``o``/``g`` object groups.
Faces without normals get flat face normals (the reference's own convention —
its generator computes per-face normals, data-generator/main.swift:69-72).
Faces with texcoords become textured attributes when ``texture`` is given;
everything else is flat-colored from a per-group palette. Copy of
``swift3drenderer_tpu.utils.objio``, building the port's ``Scene``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .databin import Scene

# Default per-group palette (0..255 floats, like models/primitives.py).
PALETTE = np.array(
    [[255, 127.5, 0], [0, 102, 255], [255, 0, 0], [0, 204, 102],
     [204, 0, 204], [255, 255, 0], [0, 255, 255], [160, 160, 160]],
    dtype=np.float32)


def _parse_index(token: str, count: int) -> Optional[int]:
    if not token:
        return None
    i = int(token)
    return i - 1 if i > 0 else count + i  # OBJ is 1-based; negatives from end


def load_obj(
    source: str,
    *,
    scale: float = 1.0,
    offset: Sequence[float] = (0.0, 0.0, 0.0),
    texture: Optional[int] = None,
    textures: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
) -> Scene:
    """Parse OBJ text or a path into a Scene.

    ``texture``: texture index applied to faces that carry texcoords; requires
    ``textures`` (NT, 512, 512) u32 atlases. ``colors``: (G, 3) per-group palette
    override. Positions become ``scale * v + offset``.
    """
    if "\n" not in source:
        with open(source) as f:
            text = f.read()
    else:
        text = source

    positions: List[List[float]] = []
    normals: List[List[float]] = []
    texcoords: List[List[float]] = []
    faces = []  # (group, [(vi, ti, ni), ...])
    group = 0
    max_group = 0
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif tag == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            texcoords.append([float(x) for x in parts[1:3]])
        elif tag in ("o", "g", "usemtl"):
            max_group += 1
            group = max_group
        elif tag == "f":
            corners = []
            for tok in parts[1:]:
                fields = tok.split("/")
                vi = _parse_index(fields[0], len(positions))
                ti = _parse_index(fields[1], len(texcoords)) if len(fields) > 1 else None
                ni = _parse_index(fields[2], len(normals)) if len(fields) > 2 else None
                corners.append((vi, ti, ni))
            # fan-triangulate polygons
            for k in range(1, len(corners) - 1):
                faces.append((group, [corners[0], corners[k], corners[k + 1]]))

    if not faces:
        raise ValueError("OBJ contains no faces")
    pos = (np.asarray(positions, np.float32) * np.float32(scale)
           + np.asarray(offset, np.float32))
    nrm = np.asarray(normals, np.float32) if normals else np.zeros((0, 3), np.float32)
    uvs = np.asarray(texcoords, np.float32) if texcoords else np.zeros((0, 2), np.float32)
    palette = colors if colors is not None else PALETTE

    out_normals, out_vec, out_tex, attr_idx = [], [], [], []
    vert_idx = []
    for g, corners in faces:
        # Face normal fallback (the reference's convention, gen:69-72). Note its
        # cross order makes front faces those wound clockwise on screen.
        p = [pos[c[0]] for c in corners]
        fn = np.cross(p[2] - p[0], p[1] - p[0])
        norm = float(np.linalg.norm(fn))
        fn = fn / norm if norm > 0 else np.array([0, 1, 0], np.float32)
        textured = texture is not None and all(c[1] is not None for c in corners)
        for vi, ti, ni in corners:
            vert_idx.append(vi)
            attr_idx.append(len(out_normals))
            n = nrm[ni] if ni is not None and ni < len(nrm) else fn
            out_normals.append(np.asarray(n, np.float32))
            if textured:
                u, v = uvs[ti]
                out_vec.append(np.array([u, 1.0 - v, 0.0], np.float32))  # OBJ v-up
                out_tex.append(int(texture))
            else:
                out_vec.append(palette[g % len(palette)])
                out_tex.append(-1)

    n3 = np.stack(out_normals)
    scene = Scene(
        vertices=np.concatenate(
            [pos, np.ones((pos.shape[0], 1), np.float32)], axis=1),
        vertex_indices=np.asarray(vert_idx, np.int64),
        normals=np.concatenate(
            [n3, np.zeros((n3.shape[0], 1), np.float32)], axis=1),
        attr_vec=np.stack(out_vec).astype(np.float32),
        attr_tex=np.asarray(out_tex, np.int64),
        attribute_indices=np.asarray(attr_idx, np.int64),
        textures=(np.asarray(textures, np.uint32) if textures is not None
                  else np.zeros((0, 512, 512), np.uint32)),
    )
    scene.validate()
    return scene
