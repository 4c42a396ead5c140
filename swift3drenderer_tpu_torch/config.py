"""Render configuration.

The reference keeps these as compile-time constants (reference render/render.swift:32-41,
render-cpp/render.cpp Config). We expose them as a real config object since benchmark
configs vary resolution and scene, but the defaults reproduce the reference exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Pipeline constants (defaults mirror reference render/render.swift:32-41)."""

    near: float = 0.1
    fov: float = math.pi / 5
    speed: float = 0.1                      # WASD translate units per frame
    rotation_speed: float = 0.3             # mouse-delta rotation scale
    background_rgb: tuple = (30.0, 30.0, 30.0)
    min_area: float = 10.0                  # signed-area cull threshold (render.swift:280)
    texture_size: int = 512                 # ripmap atlas edge (texels)
    base_level: int = 256                   # largest ripmap level per axis
    # Texture filter within the selected ripmap level: "nearest" is the
    # reference-exact fetch (render.swift:104-111); "bilinear" is this
    # framework's extension (weights from texel centers, repeat-wrapped).
    sampling: str = "nearest"

    @property
    def scale(self) -> float:
        # render.swift:35 — near * tan(fov / 2)
        return self.near * math.tan(self.fov / 2)

    def factor(self, height: int) -> float:
        # render.swift:242 — near * H / (2 * scale)
        return self.near * float(height) / (2.0 * self.scale)

    @property
    def background_packed(self) -> int:
        r, g, b = (int(c) & 0xFF for c in self.background_rgb)
        return (r << 16) | (g << 8) | b


DEFAULT_CONFIG = RenderConfig()


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """float3 [0,255] -> u32 0x00RRGGBB (reference render.swift:84-87).

    The reference truncates each channel to UInt8 (Swift traps out-of-range; the shading
    term is in [0,1] so values stay in range by construction). We truncate identically.
    """
    v = rgb.astype(np.uint32)
    return (v[..., 0] << 16) | (v[..., 1] << 8) | v[..., 2]


def unpack_rgb(packed: np.ndarray) -> np.ndarray:
    """u32 0x00RRGGBB -> float3 (reference render.swift:110)."""
    p = packed.astype(np.uint32)
    return np.stack(
        [(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1
    ).astype(np.float32)
