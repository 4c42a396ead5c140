from .scene import (  # noqa: F401
    SCENES,
    anisotropic_scene,
    clipping_scene,
    default_scene,
    icosahedron_scene,
    tetrahedron_scene,
)
