"""Seeded scene geometry builders.

These reproduce the reference data generator's geometry families
(reference data-generator/main.swift): the 30x30 textured floor quad (gen:190-216),
the textured equilateral triangle (gen:74-106), flat-colored tetrahedra (gen:218-258)
and icosahedra (gen:260-373), and the generator's per-cell regular floor
(gen:108-188). Copy of ``swift3drenderer_tpu.models.primitives``. Unlike the
reference — which uses unseeded ``Float.random`` for object orientation —
every builder here takes an explicit ``rng`` so scenes are deterministic, which
the golden-frame tests depend on.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

# Flat shading palette (the reference uses NSColor.orange/red/blue converted to
# 0..255 floats, data-generator/main.swift:65-67).
ORANGE = np.array([255.0, 127.5, 0.0], dtype=np.float32)
RED = np.array([255.0, 0.0, 0.0], dtype=np.float32)
BLUE = np.array([0.0, 0.0, 255.0], dtype=np.float32)


class SceneBuilder:
    """Accumulates vertices/indices/attributes exactly like the generator's globals
    (data-generator/main.swift:60-63)."""

    def __init__(self) -> None:
        self.vertices: List[np.ndarray] = []     # (3,) float32 positions
        self.vertex_indices: List[int] = []
        self.normals: List[np.ndarray] = []      # (3,) float32
        self.attr_vec: List[np.ndarray] = []     # RGB or (u, v, 0)
        self.attr_tex: List[int] = []            # texture index or -1
        self.attribute_indices: List[int] = []

    def add_vertex(self, v) -> None:
        self.vertices.append(np.asarray(v, dtype=np.float32))

    def add_color_attr(self, normal, color) -> None:
        self.normals.append(np.asarray(normal, dtype=np.float32))
        self.attr_vec.append(np.asarray(color, dtype=np.float32))
        self.attr_tex.append(-1)

    def add_texture_attr(self, normal, tex_index: int, uv) -> None:
        self.normals.append(np.asarray(normal, dtype=np.float32))
        u, v = uv
        self.attr_vec.append(np.array([u, v, 0.0], dtype=np.float32))
        self.attr_tex.append(int(tex_index))

    def arrays(self):
        """Finalize into the Scene array fields (textures added separately)."""
        v = np.stack(self.vertices).astype(np.float32)
        vertices4 = np.concatenate(
            [v, np.ones((v.shape[0], 1), np.float32)], axis=1
        )
        n = np.stack(self.normals).astype(np.float32)
        normals4 = np.concatenate([n, np.zeros((n.shape[0], 1), np.float32)], axis=1)
        return dict(
            vertices=vertices4,
            vertex_indices=np.asarray(self.vertex_indices, dtype=np.int64),
            normals=normals4,
            attr_vec=np.stack(self.attr_vec).astype(np.float32),
            attr_tex=np.asarray(self.attr_tex, dtype=np.int64),
            attribute_indices=np.asarray(self.attribute_indices, dtype=np.int64),
        )


def face_normal(v, a: int, b: int, c: int) -> np.ndarray:
    """normalize(cross(v[c]-v[a], v[b]-v[a])) (data-generator/main.swift:69-72)."""
    n = np.cross(v[c] - v[a], v[b] - v[a])
    return (n / np.linalg.norm(n)).astype(np.float32)


def random_unit_sphere_point(rng: np.random.Generator) -> np.ndarray:
    """Uniform point on the unit sphere (data-generator/main.swift:15-21)."""
    cz = rng.uniform(-1.0, 1.0)
    angle = rng.uniform(0.0, 2.0 * math.pi)
    s = math.sqrt(max(0.0, 1.0 - cz * cz))
    return np.array([math.cos(angle) * s, math.sin(angle) * s, cz], dtype=np.float32)


def random_unit_axis(rng: np.random.Generator):
    """Random orthonormal frame (data-generator/main.swift:23-32)."""
    x = random_unit_sphere_point(rng)
    while True:
        q = random_unit_sphere_point(rng)
        if not (np.array_equal(q, x) or np.array_equal(q, -x)):
            break
    y = np.cross(x, q)
    y = (y / np.linalg.norm(y)).astype(np.float32)
    z = np.cross(x, y).astype(np.float32)
    return x, y, z


def add_simple_floor(b: SceneBuilder, size: int = 30, tex: int = 0) -> None:
    """30x30 floor quad, 2 textured triangles, uv scale 15/size (gen:190-216)."""
    a = float(size)
    i = len(b.vertices)
    b.add_vertex([-a / 2, -0.5, -a - 2.0])
    b.add_vertex([a / 2, -0.5, -a - 2.0])
    b.add_vertex([-a / 2, -0.5, -2.0])
    b.add_vertex([a / 2, -0.5, -2.0])
    scale = 15.0 / a
    b.vertex_indices += [i, i + 1, i + 2, i + 2, i + 1, i + 3]
    up = [0.0, 1.0, 0.0]
    t1, t2 = (0.0, 0.0), (a * scale, 0.0)
    t3, t4 = (0.0, a * scale), (a * scale, a * scale)
    j = len(b.normals)
    for uv in (t1, t2, t3, t3, t2, t4):
        b.add_texture_attr(up, tex, uv)
    b.attribute_indices += list(range(j, j + 6))


def add_regular_floor(b: SceneBuilder, size: int = 30, tex: int = 1,
                      scale: float = 1.0) -> None:
    """Per-cell offset-triangle floor — the generator's disabled alternative
    (gen:108-188)."""
    a = size
    i = len(b.vertices)
    for z in range(a + 1):
        for x in range(a + 1):
            extra = 0.5 * float(z % 2)
            b.add_vertex([float(x) - a / 2.0 + extra, -0.5, -float(z) - 2.0])
    up = [0.0, 1.0, 0.0]
    for z in range(a):
        a1 = i + z * (a + 1)
        a2 = i + (z + 1) * (a + 1)
        for x in range(a):
            j = len(b.normals)
            xs = math.fmod(float(x) * scale, 1.0)
            ys = math.fmod(float(a - z - 1) * scale, 1.0)
            if z % 2 == 0:
                b.vertex_indices += [a1 + x, a2 + x, a1 + 1 + x,
                                     a1 + 1 + x, a2 + x, a2 + 1 + x]
                uvs = [(xs, ys + scale), (xs + 0.5 * scale, ys), (xs + scale, ys + scale),
                       (xs + scale, ys + scale), (xs + 0.5 * scale, ys),
                       (xs + 1.5 * scale, ys)]
            else:
                b.vertex_indices += [a1 + x, a2 + x, a2 + 1 + x,
                                     a2 + 1 + x, a1 + 1 + x, a1 + x]
                uvs = [(xs + 0.5 * scale, ys + scale), (xs, ys), (xs + scale, ys),
                       (xs + scale, ys), (xs + 1.5 * scale, ys + scale),
                       (xs + 0.5 * scale, ys + scale)]
            for uv in uvs:
                b.add_texture_attr(up, tex, uv)
            b.attribute_indices += list(range(j, j + 6))


def add_triangle(b: SceneBuilder, r: float = 1.0, p=(0.0, 0.0, -10.0),
                 tex: int = 1) -> None:
    """One textured equilateral triangle at (0, 0, -10) (gen:74-106)."""
    s3 = math.sqrt(3.0) / 2.0
    v = np.array([[-s3, -0.5, 0.0], [0.0, 1.0, 0.0], [s3, -0.5, 0.0]],
                 dtype=np.float32)
    v = r * v + np.asarray(p, dtype=np.float32)
    i = len(b.vertices)
    for vv in v:
        b.add_vertex(vv)
    b.vertex_indices += [i, i + 1, i + 2]
    n = face_normal(v, 0, 1, 2)
    j = len(b.normals)
    b.add_texture_attr(n, tex, (0.0, s3))
    b.add_texture_attr(n, tex, (0.5, 0.0))
    b.add_texture_attr(n, tex, (1.0, s3))
    b.attribute_indices += list(range(j, j + 3))


def add_tetrahedron(b: SceneBuilder, rng: np.random.Generator, r: float = 2.0,
                    p=(-10.0, 5.0, -10.0)) -> None:
    """Randomly-oriented flat-colored tetrahedron (gen:218-258)."""
    x, y, z = random_unit_axis(rng)
    k1, k2, k3 = math.sqrt(8 / 9), math.sqrt(2 / 9), math.sqrt(2 / 3)
    v = np.stack([
        z,
        k1 * x - z / 3,
        -k2 * x + k3 * y - z / 3,
        -k2 * x - k3 * y - z / 3,
    ]).astype(np.float32)
    v = r * v + np.asarray(p, dtype=np.float32)
    i = len(b.vertices)
    for vv in v:
        b.add_vertex(vv)
    faces = [(0, 2, 1), (0, 3, 2), (0, 1, 3), (1, 2, 3)]
    for f in faces:
        b.vertex_indices += [i + f[0], i + f[1], i + f[2]]
    colors = [
        (ORANGE, ORANGE, ORANGE),
        (RED, ORANGE, ORANGE),
        (ORANGE, ORANGE, BLUE),
        (ORANGE, ORANGE, ORANGE),
    ]
    j = len(b.normals)
    for f, cs in zip(faces, colors):
        n = face_normal(v, *f)
        for c in cs:
            b.add_color_attr(n, c)
    b.attribute_indices += list(range(j, j + 12))


_ICOSA_FACES = [
    (0, 1, 4), (4, 8, 0), (0, 8, 9), (9, 6, 0), (0, 6, 1),
    (1, 10, 4), (4, 10, 5), (5, 8, 4), (5, 2, 8), (8, 2, 9),
    (9, 2, 7), (7, 6, 9), (7, 11, 6), (6, 11, 1), (1, 11, 10),
    (3, 5, 10), (10, 11, 3), (3, 11, 7), (7, 2, 3), (3, 2, 5),
]

# Sparse per-corner color overrides mirroring the reference's accent corners
# (gen:310-371); everything else is orange.
_ICOSA_ACCENTS = {(3, 0): RED, (8, 0): BLUE, (8, 2): RED, (15, 0): RED}


def add_icosahedron(b: SceneBuilder, rng: np.random.Generator, r: float = 2.0,
                    p=(10.0, 5.0, -10.0)) -> None:
    """Randomly-oriented flat-colored icosahedron, 20 faces (gen:260-373)."""
    x, y, z = random_unit_axis(rng)
    phi = (math.sqrt(5.0) + 1.0) / 2.0
    l = 1.0 / math.sqrt(phi + 2.0)
    k = phi * l
    v = np.stack([
        k * x + l * y, k * x - l * y, -k * x + l * y, -k * x - l * y,
        l * x + k * z, -l * x + k * z, l * x - k * z, -l * x - k * z,
        k * y + l * z, k * y - l * z, -k * y + l * z, -k * y - l * z,
    ]).astype(np.float32)
    v = r * v + np.asarray(p, dtype=np.float32)
    i = len(b.vertices)
    for vv in v:
        b.add_vertex(vv)
    j = len(b.normals)
    for fi, f in enumerate(_ICOSA_FACES):
        b.vertex_indices += [i + f[0], i + f[1], i + f[2]]
        n = face_normal(v, *f)
        for corner in range(3):
            b.add_color_attr(n, _ICOSA_ACCENTS.get((fi, corner), ORANGE))
    b.attribute_indices += list(range(j, j + 60))
