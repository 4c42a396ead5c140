"""Scenes from a configuration file and a seed.

The benchmark's own copy of the upstream generator's geometry families
(sarastro-nl/Swift3DRenderer ``data-generator/main.swift``): the textured
floor quad (gen:190-216), the textured equilateral triangle (gen:74-106), the
flat-coloured tetrahedron (gen:218-258) and icosahedron (gen:260-373), and
procedural ripmap atlases in place of the upstream's painting scans. Every
object's orientation is drawn from the seed, all objects in one call, so a
scene of ten thousand triangles builds in milliseconds.

A configuration's ``scene`` key lists what to place (see ``configs/``):

- ``floor``: ``{"size": a, "tex": i}``, the a x a quad at y = -0.5 from
  z = -2 to -2 - a, uv scale 15 / a;
- ``triangles``: ``[{"r": .., "p": [x, y, z], "tex": i}, ...]``;
- ``objects``: ``[{"kind": "tetrahedron" | "icosahedron", "r": .., "p": [..]}]``;
- ``grid``: ``{"count": n, "r": .., "pitch": d, "heights": [..], "z0": ..,
  "kinds": [..]}``: object i at column i % side and row i // side of a
  side = ceil(sqrt(n)) square, x = pitch * (col - side / 2), y =
  heights[i % len], z = z0 - pitch * row, kind = kinds[i % len];
- ``textures``: atlas makers by name (``checker``, ``stripes``), texture i
  from maker i with seed i.

Returns plain numpy arrays in the layout of the upstream's ``data.bin``
(vertices (V, 4) w = 1, normals (A, 4) w = 0, attributes as RGB or (u, v,
0) with a texture index or -1, 3 indices a triangle, (NT, 512, 512) uint32
atlas words), which both the program under test and the reference read.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

ATLAS_EDGE = 512
BASE_LEVEL = 256
LEVELS = [256, 128, 64, 32, 16, 8, 4, 2, 1]

ORANGE = (255.0, 127.5, 0.0)
RED = (255.0, 0.0, 0.0)
BLUE = (0.0, 0.0, 255.0)

TETRA_FACES = np.array([(0, 2, 1), (0, 3, 2), (0, 1, 3), (1, 2, 3)])
TETRA_COLORS = np.array([(ORANGE, ORANGE, ORANGE), (RED, ORANGE, ORANGE),
                         (ORANGE, ORANGE, BLUE), (ORANGE, ORANGE, ORANGE)],
                        np.float32)
ICOSA_FACES = np.array([
    (0, 1, 4), (4, 8, 0), (0, 8, 9), (9, 6, 0), (0, 6, 1),
    (1, 10, 4), (4, 10, 5), (5, 8, 4), (5, 2, 8), (8, 2, 9),
    (9, 2, 7), (7, 6, 9), (7, 11, 6), (6, 11, 1), (1, 11, 10),
    (3, 5, 10), (10, 11, 3), (3, 11, 7), (7, 2, 3), (3, 2, 5),
])
ICOSA_COLORS = np.tile(np.array(ORANGE, np.float32), (20, 3, 1))
for (_f, _c), _rgb in {(3, 0): RED, (8, 0): BLUE, (8, 2): RED,
                       (15, 0): RED}.items():
    ICOSA_COLORS[_f, _c] = _rgb


class _Builder:
    """Accumulates triangles as per-corner arrays: positions (T, 3, 3),
    normals (T, 3, 3), attributes (T, 3, 3) and texture ids (T, 3)."""

    def __init__(self) -> None:
        self.pos, self.nrm, self.attr, self.tex = [], [], [], []

    def add(self, pos, nrm, attr, tex) -> None:
        self.pos.append(np.asarray(pos, np.float32).reshape(-1, 3, 3))
        self.nrm.append(np.asarray(nrm, np.float32).reshape(-1, 3, 3))
        self.attr.append(np.asarray(attr, np.float32).reshape(-1, 3, 3))
        self.tex.append(np.asarray(tex, np.int64).reshape(-1, 3))

    def arrays(self, textures: np.ndarray) -> Dict[str, np.ndarray]:
        pos = np.concatenate(self.pos)
        t = pos.shape[0]
        idx = np.arange(3 * t, dtype=np.int64)
        one = np.ones((3 * t, 1), np.float32)
        return dict(
            vertices=np.concatenate([pos.reshape(-1, 3), one], axis=1),
            vertex_indices=idx,
            normals=np.concatenate([np.concatenate(self.nrm).reshape(-1, 3),
                                    0 * one], axis=1),
            attr_vec=np.concatenate(self.attr).reshape(-1, 3),
            attr_tex=np.concatenate(self.tex).reshape(-1),
            attribute_indices=idx.copy(),
            textures=np.ascontiguousarray(textures, np.uint32),
        )


def _normalize(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def face_normals(v: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """normalize(cross(v[c] - v[a], v[b] - v[a])) (gen:69-72) for every face
    of every object: v (n, k, 3), faces (F, 3) -> (n, F, 3)."""
    a, b, c = (v[:, faces[:, i]] for i in range(3))
    return _normalize(np.cross(c - a, b - a))


def random_frames(rng: np.random.Generator, n: int):
    """n random orthonormal frames (gen:15-32): x a uniform point of the unit
    sphere, y = normalize(x cross q) for a second point q, z = x cross y."""
    cz = rng.uniform(-1.0, 1.0, (2, n))
    angle = rng.uniform(0.0, 2.0 * math.pi, (2, n))
    s = np.sqrt(np.maximum(0.0, 1.0 - cz * cz))
    pts = np.stack([np.cos(angle) * s, np.sin(angle) * s, cz], axis=-1)
    x, q = pts[0].astype(np.float32), pts[1].astype(np.float32)
    y = _normalize(np.cross(x, q))
    z = np.cross(x, y).astype(np.float32)
    return x, y, z


def tetrahedra(x, y, z, r, p) -> np.ndarray:
    """(n, 4, 3) corners of randomly oriented tetrahedra (gen:218-258)."""
    k1, k2, k3 = math.sqrt(8 / 9), math.sqrt(2 / 9), math.sqrt(2 / 3)
    v = np.stack([z, k1 * x - z / 3, -k2 * x + k3 * y - z / 3,
                  -k2 * x - k3 * y - z / 3], axis=1)
    return (r[:, None, None] * v + p[:, None, :]).astype(np.float32)


def icosahedra(x, y, z, r, p) -> np.ndarray:
    """(n, 12, 3) corners of randomly oriented icosahedra (gen:260-373)."""
    phi = (math.sqrt(5.0) + 1.0) / 2.0
    l = 1.0 / math.sqrt(phi + 2.0)
    k = phi * l
    v = np.stack([k * x + l * y, k * x - l * y, -k * x + l * y, -k * x - l * y,
                  l * x + k * z, -l * x + k * z, l * x - k * z, -l * x - k * z,
                  k * y + l * z, k * y - l * z, -k * y + l * z, -k * y - l * z],
                 axis=1)
    return (r[:, None, None] * v + p[:, None, :]).astype(np.float32)


_SOLIDS = {"tetrahedron": (tetrahedra, TETRA_FACES, TETRA_COLORS),
           "icosahedron": (icosahedra, ICOSA_FACES, ICOSA_COLORS)}


def _add_solids(b: _Builder, kind: str, x, y, z, r, p) -> None:
    make, faces, colors = _SOLIDS[kind]
    v = make(x, y, z, r, p)
    n = v.shape[0]
    nrm = np.repeat(face_normals(v, faces)[:, :, None, :], 3, axis=2)
    b.add(v[:, faces], nrm, np.broadcast_to(colors, (n, *colors.shape)),
          np.full((n, len(faces), 3), -1))


def _add_floor(b: _Builder, size: float, tex: int) -> None:
    a = float(size)
    v = np.array([[-a / 2, -0.5, -a - 2.0], [a / 2, -0.5, -a - 2.0],
                  [-a / 2, -0.5, -2.0], [a / 2, -0.5, -2.0]], np.float32)
    s = a * (15.0 / a)
    uv = np.array([[0, 0, 0], [s, 0, 0], [0, s, 0], [s, s, 0]], np.float32)
    tri = np.array([[0, 1, 2], [2, 1, 3]])
    b.add(v[tri], np.broadcast_to([0.0, 1.0, 0.0], (2, 3, 3)), uv[tri],
          np.full((2, 3), tex))


def _add_triangle(b: _Builder, r: float, p, tex: int) -> None:
    s3 = math.sqrt(3.0) / 2.0
    v = (r * np.array([[-s3, -0.5, 0.0], [0.0, 1.0, 0.0], [s3, -0.5, 0.0]])
         + np.asarray(p)).astype(np.float32)
    n = face_normals(v[None], np.array([(0, 1, 2)]))[0, 0]
    uv = np.array([[0.0, s3, 0.0], [0.5, 0.0, 0.0], [1.0, s3, 0.0]], np.float32)
    b.add(v, np.broadcast_to(n, (3, 3)), uv, np.full(3, tex))


def _grid(spec: dict):
    """Kinds, radii and positions of a grid's objects (module docstring)."""
    count = int(spec["count"])
    side = max(1, math.ceil(math.sqrt(count)))
    i = np.arange(count)
    col, row = i % side, i // side
    heights = np.asarray(spec["heights"], np.float64)
    kinds = [spec["kinds"][k % len(spec["kinds"])] for k in range(count)]
    p = np.stack([spec["pitch"] * (col - side / 2.0),
                  heights[i % len(heights)],
                  spec["z0"] - spec["pitch"] * row], axis=1)
    return kinds, np.full(count, float(spec["r"])), p


def build(config: dict, seed: int) -> Dict[str, np.ndarray]:
    """The scene arrays of ``config["scene"]`` with orientations from
    ``seed``: the same seed gives the same arrays."""
    spec = config["scene"]
    rng = np.random.default_rng(seed)
    b = _Builder()
    if "floor" in spec:
        _add_floor(b, spec["floor"]["size"], spec["floor"]["tex"])
    for t in spec.get("triangles", []):
        _add_triangle(b, t["r"], t["p"], t["tex"])
    kinds = [o["kind"] for o in spec.get("objects", [])]
    radii = [float(o["r"]) for o in spec.get("objects", [])]
    pos = [o["p"] for o in spec.get("objects", [])]
    if "grid" in spec:
        gk, gr, gp = _grid(spec["grid"])
        kinds += gk
        radii += list(gr)
        pos += list(gp)
    kinds = np.asarray(kinds)
    radii = np.asarray(radii, np.float32)
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    x, y, z = random_frames(rng, len(kinds))
    for kind in _SOLIDS:          # tetrahedra first, then icosahedra
        sel = kinds == kind
        if sel.any():
            _add_solids(b, kind, x[sel], y[sel], z[sel], radii[sel], pos[sel])
    textures = np.stack([ATLASES[name](seed=i)
                         for i, name in enumerate(spec["textures"])])
    return b.arrays(textures)


# ---------------------------------------------------------------------------
# Procedural ripmap atlases.

def _level_offset(level: int) -> int:
    """Per-axis atlas offset of a power-of-two level (render.swift:107)."""
    return 511 & ~(2 * level - 1)


def ripmap_atlas(base: np.ndarray) -> np.ndarray:
    """(512, 512) uint32 0x00RRGGBB words of the ripmap atlas of a 256 x 256
    RGB base: level (ly, lx) is the base box-filtered to ly x lx and rounded,
    stored at (offset(ly), offset(lx)). The box means are built by halving
    one axis at a time from exact float64 means, so every level equals the
    direct box mean of the base."""
    atlas = np.zeros((ATLAS_EDGE, ATLAS_EDGE, 3), np.uint8)
    rows = base.astype(np.float64)
    for ly in LEVELS:
        img = rows
        for lx in LEVELS:
            oy, ox = _level_offset(ly), _level_offset(lx)
            atlas[oy:oy + ly, ox:ox + lx] = np.round(img)
            if lx > 1:
                img = 0.5 * (img[:, 0::2] + img[:, 1::2])
        if ly > 1:
            rows = 0.5 * (rows[0::2] + rows[1::2])
    a = atlas.astype(np.uint32)
    return (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]


def checker_atlas(seed: int) -> np.ndarray:
    """A coloured checkerboard with smooth gradients."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:BASE_LEVEL, 0:BASE_LEVEL].astype(np.float32) / BASE_LEVEL
    checker = ((np.floor(yy * 8) + np.floor(xx * 8)) % 2).astype(np.float32)
    c0 = rng.integers(40, 216, size=3).astype(np.float32)
    c1 = rng.integers(40, 216, size=3).astype(np.float32)
    base = checker[..., None] * c0 + (1 - checker[..., None]) * c1
    base += 40.0 * np.stack([xx, yy, 1 - xx], axis=-1)
    return ripmap_atlas(np.clip(base, 0, 255).astype(np.uint8))


def stripes_atlas(seed: int) -> np.ndarray:
    """Diagonal stripes plus radial rings."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:BASE_LEVEL, 0:BASE_LEVEL].astype(np.float32) / BASE_LEVEL
    stripes = 0.5 + 0.5 * np.sin((xx + yy) * 16 * np.pi)
    rings = 0.5 + 0.5 * np.cos(np.hypot(xx - 0.5, yy - 0.5) * 24 * np.pi)
    c0 = rng.integers(40, 216, size=3).astype(np.float32)
    c1 = rng.integers(40, 216, size=3).astype(np.float32)
    base = stripes[..., None] * c0 + rings[..., None] * c1 * 0.5
    return ripmap_atlas(np.clip(base, 0, 255).astype(np.uint8))


ATLASES = {"checker": checker_atlas, "stripes": stripes_atlas}
