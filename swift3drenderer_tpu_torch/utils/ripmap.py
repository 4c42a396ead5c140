"""Anisotropic ripmap atlas construction.

Copy of the atlas construction of ``swift3drenderer_tpu.utils.ripmap``. Every
anisotropic level pair (2^i x 2^j), i, j <= 8, is box-filtered and stored at the
per-axis offset ``offset(L) = 511 & ~(2L - 1) = 512 - 2L`` (reference
render/render.swift:104-111):

    level:   256  128   64  32  16   8   4   2   1
    offset:    0  256  384 448 480 496 504 508 510
"""

from __future__ import annotations

import numpy as np

ATLAS_EDGE = 512
BASE_LEVEL = 256
LEVELS = [256, 128, 64, 32, 16, 8, 4, 2, 1]


def level_offset(level: int) -> int:
    """Per-axis atlas offset of a power-of-two level (render.swift:107 ``511 & ~(2L-1)``)."""
    return 511 & ~(2 * level - 1)


def _box_downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Average-pool an (H, W, C) image to (out_h, out_w, C); H/W divisible by out."""
    h, w = img.shape[:2]
    fy, fx = h // out_h, w // out_w
    x = img.reshape(out_h, fy, out_w, fx, -1).astype(np.float64)
    return x.mean(axis=(1, 3))


def build_ripmap_atlas(base: np.ndarray) -> np.ndarray:
    """Build a 512x512 RGB ripmap atlas (uint8) from a base image.

    ``base`` is (H, W, 3) uint8; it is first box-resampled to 256x256 if needed
    (H and W must be power-of-two multiples of 256 in that case).
    """
    if base.shape[:2] != (BASE_LEVEL, BASE_LEVEL):
        base = np.round(_box_downsample(base, BASE_LEVEL, BASE_LEVEL)).astype(np.uint8)
    atlas = np.zeros((ATLAS_EDGE, ATLAS_EDGE, 3), dtype=np.uint8)
    for ly in LEVELS:
        for lx in LEVELS:
            block = np.round(_box_downsample(base, ly, lx)).astype(np.uint8)
            oy, ox = level_offset(ly), level_offset(lx)
            atlas[oy : oy + ly, ox : ox + lx] = block
    return atlas
