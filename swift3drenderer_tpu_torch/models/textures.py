"""Procedural texture sources.

Copy of the procedural half of ``swift3drenderer_tpu.models.textures``:
deterministic base images turned into ripmap atlases by
:mod:`swift3drenderer_tpu_torch.utils.ripmap`.
"""

from __future__ import annotations

import numpy as np

from ..utils.ppm import pack_rgb_words
from ..utils.ripmap import BASE_LEVEL, build_ripmap_atlas


def checker_base(seed: int = 0, edge: int = BASE_LEVEL) -> np.ndarray:
    """A colored checkerboard with smooth gradients — high-frequency content that
    makes mip/ripmap level selection visible in tests."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:edge, 0:edge].astype(np.float32) / edge
    cells = 8
    checker = ((np.floor(yy * cells) + np.floor(xx * cells)) % 2).astype(np.float32)
    c0 = rng.integers(40, 216, size=3).astype(np.float32)
    c1 = rng.integers(40, 216, size=3).astype(np.float32)
    base = checker[..., None] * c0 + (1 - checker[..., None]) * c1
    base += 40.0 * np.stack([xx, yy, 1 - xx], axis=-1)
    return np.clip(base, 0, 255).astype(np.uint8)


def stripes_base(seed: int = 1, edge: int = BASE_LEVEL) -> np.ndarray:
    """Diagonal stripes plus radial rings."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:edge, 0:edge].astype(np.float32) / edge
    stripes = 0.5 + 0.5 * np.sin((xx + yy) * 16 * np.pi)
    rings = 0.5 + 0.5 * np.cos(np.hypot(xx - 0.5, yy - 0.5) * 24 * np.pi)
    c0 = rng.integers(40, 216, size=3).astype(np.float32)
    c1 = rng.integers(40, 216, size=3).astype(np.float32)
    base = stripes[..., None] * c0 + rings[..., None] * c1 * 0.5
    return np.clip(base, 0, 255).astype(np.uint8)


def default_texture_words(num: int = 2) -> np.ndarray:
    """(num, 512, 512) u32 ripmap-atlas words for texture indices 0..num-1."""
    makers = [checker_base, stripes_base]
    out = []
    for i in range(num):
        base = makers[i % len(makers)](seed=i)
        out.append(pack_rgb_words(build_ripmap_atlas(base)))
    return np.stack(out).astype(np.uint32)
