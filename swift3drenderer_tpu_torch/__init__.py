"""swift3drenderer_tpu_torch — the renderer of ``swift3drenderer_tpu`` on
PyTorch, with its TPU kernel rewritten by hand in CUDA C++ for Hopper.

The package imports torch and numpy only: the numpy modules it shares with the
JAX package (config, camera, scene container and factories, textures, the
golden oracle, the app's input, telemetry and data tools) are kept here as
copies. Entry points default to ``device="cuda"``; pass ``device="cpu"`` to
run the plain PyTorch version of every kernel. ``Renderer(backend="xla")``
rasterizes with ``ops.raster_xla`` instead of the kernels. ``app`` and
``viewer`` are the application shell; ``ShardedRenderer`` and the rest of
``parallel`` render over torch.distributed ranks.
"""

from .camera import Camera, GamepadState, Input, KeyboardState
from .config import DEFAULT_CONFIG, RenderConfig
from .parallel import ShardedRenderer
from .renderer import Renderer
from .utils.databin import Scene, dump_scene, load_scene

__all__ = [
    "Camera",
    "DEFAULT_CONFIG",
    "GamepadState",
    "Input",
    "KeyboardState",
    "RenderConfig",
    "Renderer",
    "Scene",
    "ShardedRenderer",
    "dump_scene",
    "load_scene",
]
