"""Ripmap texture sampling (counterpart of ``swift3drenderer_tpu.ops.texture``):
the vectorized form of the reference's ``getTextureColor``
(render/render.swift:94-111), nearest, and bilinear within the selected level
(the JAX package's extension, ``RenderConfig.sampling="bilinear"``).

The atlases (one 512x512 u32 image per texture) are one ``(NT, 512, 512)``
int32 tensor (the words are below 2^24, so int32 holds them unchanged).
Addressing is reference-exact: per-axis level clamp to [1, 256],
truncate-then-next-power-of-two, and texel address
``trunc(fmod(uv, 1) * L) + (511 & ~(2L - 1))``. Bilinear taps the four texels
around ``mod(uv, 1) * L - 0.5`` (texel centers at integer + 0.5), wrapped
inside the level's block. The CUDA raster kernels (csrc/raster.cu,
``texel_axis`` and ``bilinear_axis``) compute the same.
"""

from __future__ import annotations

import torch

from .setup import trunc_i32

ATLAS_EDGE = 512


def next_power_of_two(level: torch.Tensor) -> torch.Tensor:
    """Truncate-then-round-up-to-pow2 on int32 (render.swift:95-101); valid for
    clamped inputs in [1, 256] so two shift rounds cover all 8 bits."""
    i = trunc_i32(level) - 1
    i = i | (i >> 1)
    i = i | (i >> 2)
    i = i | (i >> 4)
    return i + 1


def _level(level: torch.Tensor) -> torch.Tensor:
    """The per-axis power-of-two level, non-finite levels sanitized."""
    return next_power_of_two(torch.nan_to_num(
        level, nan=256.0, posinf=256.0, neginf=1.0).clamp(1.0, 256.0))


def texel_index(tex_idx: torch.Tensor, uv: torch.Tensor, level: torch.Tensor,
                num_textures: int) -> torch.Tensor:
    """Flat index into ``textures.reshape(-1)`` of the nearest texel of the
    anisotropic ripmap, int64 (...,). tex_idx: (...,) int32; uv/level:
    (..., 2). Non-finite uv/level are sanitized so the index stays in range.
    """
    lp = _level(level)
    frac = torch.fmod(torch.nan_to_num(uv), 1.0)
    t = trunc_i32(frac * lp)             # truncates toward zero like Swift Int()
    addr = t + (511 & ~(2 * lp - 1))     # Swift & binds at * precedence
    x = addr[..., 0].clamp(0, ATLAS_EDGE - 1).long()
    y = addr[..., 1].clamp(0, ATLAS_EDGE - 1).long()
    tex = tex_idx.clamp(0, max(num_textures - 1, 0)).long()
    return (tex * ATLAS_EDGE + y) * ATLAS_EDGE + x


def _channels(words: torch.Tensor) -> torch.Tensor:
    """Packed 0x00RRGGBB words -> (..., 3) float32 RGB."""
    return torch.stack([(words >> 16) & 0xFF, (words >> 8) & 0xFF, words & 0xFF],
                       dim=-1).to(torch.float32)


def sample_ripmap(textures: torch.Tensor, tex_idx: torch.Tensor,
                  uv: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor anisotropic ripmap fetch.

    textures: (NT, 512, 512) int32; tex_idx: (...,) int32; uv/level: (..., 2).
    Returns (..., 3) float32 RGB in [0, 255].
    """
    return _channels(textures.reshape(-1)[texel_index(tex_idx, uv, level,
                                                      textures.shape[0])])


def bilinear_taps(tex_idx: torch.Tensor, uv: torch.Tensor, level: torch.Tensor,
                  num_textures: int):
    """The four texels of the bilinear fetch and their weights.

    Returns (flat indices into ``textures.reshape(-1)``, int64 (..., 4), in
    the order (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1); weights
    (wx, wy), f32 (..., 2)). tex_idx: (...,) int32; uv/level: (..., 2),
    sanitized as ``texel_index`` sanitizes them. The wrap is the floor-mod of
    ``jnp.mod`` (``torch.remainder``), so a tiny negative u gives 1.0; the tap
    ``(x0 + 1) & (L - 1)`` then wraps back to the level's first texel.
    """
    lp = _level(level)
    t = torch.remainder(torch.nan_to_num(uv), 1.0) * lp - 0.5
    f = torch.floor(t)
    x0 = f.to(torch.int32)               # t lies in [-0.5, L - 0.5]
    off = 511 & ~(2 * lp - 1)
    lo = (x0 & (lp - 1)) + off           # mod(x0, L): L is a power of two
    hi = ((x0 + 1) & (lp - 1)) + off
    tex = tex_idx.clamp(0, max(num_textures - 1, 0)).long()

    def flat(x, y):
        return (tex * ATLAS_EDGE + y.long()) * ATLAS_EDGE + x.long()

    idx = torch.stack([flat(lo[..., 0], lo[..., 1]), flat(hi[..., 0], lo[..., 1]),
                       flat(lo[..., 0], hi[..., 1]), flat(hi[..., 0], hi[..., 1])],
                      dim=-1)
    return idx, t - f


def sample_ripmap_bilinear(textures: torch.Tensor, tex_idx: torch.Tensor,
                           uv: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch within the selected ripmap level (counterpart of JAX
    ``ops/texture.py::sample_ripmap_bilinear``): the four taps weighted
    (1 - wx, wx) x (1 - wy, wy) as float channels, summed left to right in
    the JAX package's order. Returns (..., 3) float32 RGB in [0, 255]."""
    idx, w = bilinear_taps(tex_idx, uv, level, textures.shape[0])
    ch = _channels(textures.reshape(-1)[idx])              # (..., 4, 3)
    wx, wy = w[..., 0:1], w[..., 1:2]
    return ((1 - wx) * (1 - wy) * ch[..., 0, :] + wx * (1 - wy) * ch[..., 1, :]
            + (1 - wx) * wy * ch[..., 2, :] + wx * wy * ch[..., 3, :])
