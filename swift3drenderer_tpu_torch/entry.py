"""Entry hook of the port: the counterpart of ``__graft_entry__.entry()``.

    from swift3drenderer_tpu_torch.entry import entry
    fn, args = entry()          # device="cpu" for the plain versions
    pixels = fn(*args)          # (480, 640) int32 0x00RRGGBB on the device

One 640x480 frame of the default scene (seed 0) at the identity camera
through the port's main path: ``Renderer(backend="cuda").render_device``
(a captured graph on the card). The JAX hook renders through
``render_frame_xla`` under ``jax.jit``.
"""

from __future__ import annotations

from .camera import Camera, Input
from .models import default_scene
from .renderer import Renderer

WIDTH, HEIGHT = 640, 480


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(renderer, matrix)`` renders one frame
    and returns its pixels."""
    renderer = Renderer(default_scene(seed=0), device=device)
    m = Camera().update(Input(), force_update=True)

    def fn(r, matrix):
        pixels, _ = r.render_device(matrix, WIDTH, HEIGHT)
        return pixels

    return fn, (renderer, m)
