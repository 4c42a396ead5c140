"""Texture sources.

Copy of ``swift3drenderer_tpu.models.textures``: deterministic procedural
base images, and photographs bundled with installed packages (PIL,
scikit-learn and matplotlib, imported only when a photo is asked for),
turned into ripmap atlases by :mod:`swift3drenderer_tpu_torch.utils.ripmap`.
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


def _photo_sources():
    """Paths of real photographs bundled with installed packages.

    The reference ships two painting scans as its texture artwork
    (data-generator/ppms/, README.md:21); we don't copy those assets, so the
    non-procedural default uses freely redistributable sample photographs that
    ship with scikit-learn (china.jpg, flower.jpg — CC-licensed example data)
    and matplotlib (grace_hopper.jpg).
    """
    import os
    paths = []
    try:
        import sklearn.datasets as skd
        img_dir = os.path.join(os.path.dirname(skd.__file__), "images")
        for name in ("china.jpg", "flower.jpg"):
            p = os.path.join(img_dir, name)
            if os.path.exists(p):
                paths.append(p)
    except ImportError:
        pass
    try:
        import matplotlib
        p = os.path.join(matplotlib.get_data_path(), "sample_data",
                         "grace_hopper.jpg")
        if os.path.exists(p):
            paths.append(p)
    except ImportError:
        pass
    return paths


def photo_base(index: int = 0, edge: int = BASE_LEVEL) -> np.ndarray:
    """A real photograph, center-cropped square and resampled to the ripmap
    base level — the non-procedural analog of the reference's painting scans.

    Raises RuntimeError when no bundled sample photo is available (no network
    access is assumed; callers fall back to the procedural textures).
    """
    from PIL import Image

    paths = _photo_sources()
    if not paths:
        raise RuntimeError(
            "no bundled sample photographs found (need scikit-learn or "
            "matplotlib); use the procedural textures instead")
    img = Image.open(paths[index % len(paths)]).convert("RGB")
    w, h = img.size
    side = min(w, h)
    img = img.crop(((w - side) // 2, (h - side) // 2,
                    (w - side) // 2 + side, (h - side) // 2 + side))
    # Resample to 2x the base level, then let the atlas builder's box filter
    # produce the 256x256 base — a cheap approximation of proper prefiltering.
    img = img.resize((2 * edge, 2 * edge), Image.LANCZOS)
    return np.asarray(img, dtype=np.uint8)


def photo_texture_words(num: int = 2) -> np.ndarray:
    """(num, 512, 512) u32 ripmap atlases built from real photographs."""
    return np.stack([
        pack_rgb_words(build_ripmap_atlas(photo_base(i)))
        for i in range(num)
    ]).astype(np.uint32)
