"""Scene composition — the framework's scene families.

Copy of ``swift3drenderer_tpu.models.scene``. ``default_scene`` reproduces the
reference generator's composition (reference data-generator/main.swift:375-379):
simple floor + 1 textured triangle + 2 tetrahedra + 2 icosahedra (39 vertices,
51 triangles, 2 textures). Four more are the benchmark configs of BASELINE.json
(flat tetrahedron, textured icosahedron, anisotropic floor, clipping stress);
``stress``, ``stress100k`` and ``regular_floor`` are the large scenes of
bench.py's scale rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.databin import Scene
from . import primitives as prim
from .textures import default_texture_words


def _finish(b: prim.SceneBuilder, textures: Optional[np.ndarray],
            num_textures: int) -> Scene:
    if textures is None:
        textures = default_texture_words(num_textures) if num_textures else (
            np.zeros((0, 512, 512), np.uint32))
    scene = Scene(textures=np.asarray(textures, dtype=np.uint32), **b.arrays())
    scene.validate()
    return scene


def default_scene(seed: int = 0, textures: Optional[np.ndarray] = None) -> Scene:
    """Full mixed scene (gen:375-379): floor + triangle + 2 tetra + 2 icosa."""
    rng = np.random.default_rng(seed)
    b = prim.SceneBuilder()
    prim.add_simple_floor(b)
    prim.add_triangle(b)
    for i in range(2):
        prim.add_tetrahedron(b, rng, p=(-10.0 + 4.0 * i, 5.0, -10.0 - 3.0 * i))
    for i in range(2):
        prim.add_icosahedron(b, rng, p=(10.0 - 4.0 * i, 5.0, -10.0 - 3.0 * i))
    return _finish(b, textures, 2)


def tetrahedron_scene(seed: int = 0) -> Scene:
    """BASELINE config 1: flat-colored tetrahedron only, no textures."""
    rng = np.random.default_rng(seed)
    b = prim.SceneBuilder()
    prim.add_tetrahedron(b, rng, p=(0.0, 0.0, -6.0))
    return _finish(b, None, 0)


def icosahedron_scene(seed: int = 0, textures: Optional[np.ndarray] = None) -> Scene:
    """BASELINE config 2: icosahedron plus textured floor for the fly-through."""
    rng = np.random.default_rng(seed)
    b = prim.SceneBuilder()
    prim.add_simple_floor(b)
    prim.add_icosahedron(b, rng, p=(0.0, 2.0, -8.0))
    return _finish(b, textures, 1)


def anisotropic_scene(seed: int = 0, textures: Optional[np.ndarray] = None) -> Scene:
    """BASELINE config 3: large textured floor seen at shallow angles — exercises
    the per-axis ripmap level selection."""
    b = prim.SceneBuilder()
    prim.add_simple_floor(b, size=60)
    prim.add_triangle(b, p=(0.0, 1.0, -40.0), tex=1)
    return _finish(b, textures, 2)


def clipping_scene(seed: int = 0) -> Scene:
    """BASELINE config 4: geometry straddling the near plane when the camera flies
    through it — dense cluster of large triangles around the origin path."""
    rng = np.random.default_rng(seed)
    b = prim.SceneBuilder()
    prim.add_simple_floor(b)
    for i in range(4):
        prim.add_tetrahedron(b, rng, r=3.0, p=(0.0, 0.0, -4.0 * (i + 1)))
    for i in range(2):
        prim.add_icosahedron(b, rng, r=3.0, p=(2.0, 1.0, -6.0 * (i + 1)))
    return _finish(b, None, 1)


def stress_scene(seed: int = 0, objects: int = 64,
                 textures: Optional[np.ndarray] = None) -> Scene:
    """Scaled-up scene for throughput benchmarking: a field of icosahedra and
    tetrahedra above a textured floor (triangle count ~= 24 * objects + 3)."""
    rng = np.random.default_rng(seed)
    b = prim.SceneBuilder()
    prim.add_simple_floor(b, size=80)
    prim.add_triangle(b)
    side = max(1, int(np.ceil(np.sqrt(objects))))
    for i in range(objects):
        gx, gz = i % side, i // side
        p = (-2.0 * side + 4.0 * gx, 2.0 + 2.0 * (i % 3),
             -6.0 - 4.0 * gz)
        if i % 2 == 0:
            prim.add_icosahedron(b, rng, r=1.5, p=p)
        else:
            prim.add_tetrahedron(b, rng, r=1.5, p=p)
    return _finish(b, textures, 2)


def regular_floor_scene(seed: int = 0, size: int = 30,
                        textures: Optional[np.ndarray] = None) -> Scene:
    """The generator's alternative per-cell floor (gen:108-188): a size x size
    grid of offset textured triangles plus the polyhedra — 2 + 2*size^2 + 48
    triangles, a mid-size geometry workload."""
    rng = np.random.default_rng(seed)
    b = prim.SceneBuilder()
    prim.add_regular_floor(b, size=size)
    for i in range(2):
        prim.add_tetrahedron(b, rng, p=(-10.0 + 4.0 * i, 5.0, -10.0 - 3.0 * i))
    for i in range(2):
        prim.add_icosahedron(b, rng, p=(10.0 - 4.0 * i, 5.0, -10.0 - 3.0 * i))
    return _finish(b, textures, 2)


def stress100k_scene(seed: int = 0, objects: int = 8400,
                     textures: Optional[np.ndarray] = None) -> Scene:
    """The stress field an order of magnitude up: 8400 polyhedra, 100,803
    triangles (the icosa/tetra mix averages 12 faces per object, plus floor
    and marker)."""
    return stress_scene(seed=seed, objects=objects, textures=textures)


SCENES = {
    "default": default_scene,
    "tetrahedron": tetrahedron_scene,
    "icosahedron": icosahedron_scene,
    "anisotropic": anisotropic_scene,
    "clipping": clipping_scene,
    "stress": stress_scene,
    "stress100k": stress100k_scene,
    "regular_floor": regular_floor_scene,
}
