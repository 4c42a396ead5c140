from .scene import (  # noqa: F401
    SCENES,
    anisotropic_scene,
    clipping_scene,
    default_scene,
    icosahedron_scene,
    regular_floor_scene,
    stress100k_scene,
    stress_scene,
    tetrahedron_scene,
)
