"""Anisotropic ripmap atlas construction and addressing, in numpy.

Copy of ``swift3drenderer_tpu.utils.ripmap``. The reference samples textures
from a 512x512 *ripmap atlas*: every anisotropic level pair (2^i x 2^j),
i, j <= 8, is prefiltered and stored at a per-axis offset
``offset(L) = 511 & ~(2L - 1) = 512 - 2L`` (reference render/render.swift:104-111).
The base 256x256 level sits at (0, 0); halving a level doubles its offset distance
from 512, packing the whole pyramid exactly:

    level:   256  128   64  32  16   8   4   2   1
    offset:    0  256  384 448 480 496 504 508 510

``build_ripmap_atlas`` rebuilds such atlases from a plain base image with box
filtering; ``sample_ripmap`` and ``sample_ripmap_bilinear`` are the golden
oracle's samplers (the device's are in ``ops/texture.py``).
"""

from __future__ import annotations

import numpy as np

ATLAS_EDGE = 512
BASE_LEVEL = 256
LEVELS = [256, 128, 64, 32, 16, 8, 4, 2, 1]


def level_offset(level: int) -> int:
    """Per-axis atlas offset of a power-of-two level (render.swift:107 ``511 & ~(2L-1)``)."""
    return 511 & ~(2 * level - 1)


def next_power_of_two(x: float) -> int:
    """Round up to a power of two after truncating to int (render.swift:95-101).

    Matches the reference exactly: the float is truncated toward zero first, so e.g.
    3.7 -> 4 but 4.9 -> 4. Valid for inputs in [1, 256].
    """
    i = int(x) - 1
    i |= i >> 1
    i |= i >> 2
    i |= i >> 4
    return i + 1


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


def sample_ripmap(words: np.ndarray, uv: np.ndarray, level: np.ndarray) -> np.ndarray:
    """Reference-exact nearest-neighbor ripmap fetch (render.swift:104-111), vectorized.

    Args:
      words: (512, 512) u32 atlas for one texture.
      uv:    (..., 2) float32 texture coordinates (pre-divide, unwrapped).
      level: (..., 2) float32 anisotropy level estimate per axis.

    Returns (..., 3) float32 RGB in [0, 255].
    """
    # NaN/inf levels and uvs only occur on pixels that are masked out downstream
    # (the reference never evaluates them); sanitize so vectorized indexing is safe.
    lv = np.clip(np.nan_to_num(level, nan=256.0, posinf=256.0, neginf=1.0), 1.0, 256.0)
    li = lv.astype(np.int64) - 1  # truncate toward zero (inputs >= 1)
    li |= li >> 1
    li |= li >> 2
    li |= li >> 4
    lp = li + 1  # per-axis power-of-two level
    frac = np.fmod(np.nan_to_num(uv), 1.0)  # C fmod: result has the sign of uv
    t = (frac * lp).astype(np.int64)  # truncate toward zero, like Swift Int()
    # Swift's & binds at multiplication precedence, so render.swift:107 reads
    # t + (511 & ~(2L - 1)) = t + level_offset(L); the C++ twin parenthesizes the
    # same way (render.cpp:128-129).
    addr = t + (511 & ~(2 * lp - 1))
    x = np.clip(addr[..., 0], 0, ATLAS_EDGE - 1)
    y = np.clip(addr[..., 1], 0, ATLAS_EDGE - 1)
    rgb = words[y, x].astype(np.uint32)
    return np.stack(
        [(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF], axis=-1
    ).astype(np.float32)


def sample_ripmap_bilinear(words: np.ndarray, uv: np.ndarray,
                           level: np.ndarray) -> np.ndarray:
    """Bilinear fetch within the selected ripmap level (framework extension; the
    reference is nearest-only). Texel centers at integer+0.5, repeat wrapping.

    Same signature as :func:`sample_ripmap`; returns (..., 3) float32 RGB.
    """
    lv = np.clip(np.nan_to_num(level, nan=256.0, posinf=256.0, neginf=1.0), 1.0, 256.0)
    li = lv.astype(np.int64) - 1
    li |= li >> 1
    li |= li >> 2
    li |= li >> 4
    lp = li + 1                                        # per-axis pow2 level
    frac = np.mod(np.nan_to_num(uv), 1.0)              # positive wrap
    t = frac * lp - 0.5
    t0 = np.floor(t).astype(np.int64)
    w = (t - t0).astype(np.float32)                    # (..., 2) blend weights
    off = 511 & ~(2 * lp - 1)

    def fetch(ix, iy):
        x = np.clip((ix % lp[..., 0]) + off[..., 0], 0, ATLAS_EDGE - 1)
        y = np.clip((iy % lp[..., 1]) + off[..., 1], 0, ATLAS_EDGE - 1)
        rgb = words[y, x].astype(np.uint32)
        return np.stack(
            [(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF], axis=-1
        ).astype(np.float32)

    x0, y0 = t0[..., 0], t0[..., 1]
    wx, wy = w[..., 0:1], w[..., 1:2]
    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return ((1 - wx) * (1 - wy) * c00 + wx * (1 - wy) * c10
            + (1 - wx) * wy * c01 + wx * wy * c11)
