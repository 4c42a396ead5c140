"""Binary PPM (P6) image IO.

The reference's texture assets are 512x512 P6 PPMs with the fixed 15-byte header
``P6\\n512 512\\n255\\n`` whose pixel payload is a precomputed anisotropic ripmap atlas;
the data generator strips the header and packs RGB bytes into u32 words
(reference data-generator/main.swift:402-416). This module is a general P6
reader/writer used by the texture pipeline and tests. Copy of
``swift3drenderer_tpu.utils.ppm``; the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM into an (H, W, 3) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError(f"{path}: not a binary P6 PPM")
    # Parse header: magic, width, height, maxval — whitespace separated, with
    # optional '#' comment lines.
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    width, height, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: only maxval 255 supported, got {maxval}")
    pixels = np.frombuffer(data, dtype=np.uint8, count=width * height * 3, offset=pos)
    return pixels.reshape(height, width, 3).copy()


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as binary P6."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(image.tobytes())


def pack_rgb_words(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) u32 0x00RRGGBB words (gen main.swift:412-414)."""
    img = image.astype(np.uint32)
    return (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]


def unpack_rgb_words(words: np.ndarray) -> np.ndarray:
    """(H, W) u32 -> (H, W, 3) uint8."""
    w = words.astype(np.uint32)
    return np.stack([(w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF], axis=-1).astype(
        np.uint8
    )
