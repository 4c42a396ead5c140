"""Packing of RGB images into the atlas's u32 words.

Copy of the one function of ``swift3drenderer_tpu.utils.ppm`` that the texture
code needs; the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def pack_rgb_words(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) u32 0x00RRGGBB words (gen main.swift:412-414)."""
    img = image.astype(np.uint32)
    return (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]
