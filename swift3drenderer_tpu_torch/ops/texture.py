"""Ripmap texture sampling (counterpart of ``swift3drenderer_tpu.ops.texture``):
the vectorized form of the reference's ``getTextureColor``
(render/render.swift:94-111), nearest filter only.

The atlases (one 512x512 u32 image per texture) are one ``(NT, 512, 512)``
int32 tensor (the words are below 2^24, so int32 holds them unchanged).
Addressing is reference-exact: per-axis level clamp to [1, 256],
truncate-then-next-power-of-two, and texel address
``trunc(fmod(uv, 1) * L) + (511 & ~(2L - 1))``. The CUDA raster kernel
(csrc/raster.cu, ``texel_axis``) computes the same.
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


def texel_index(tex_idx: torch.Tensor, uv: torch.Tensor, level: torch.Tensor,
                num_textures: int) -> torch.Tensor:
    """Flat index into ``textures.reshape(-1)`` of the nearest texel of the
    anisotropic ripmap, int64 (...,). tex_idx: (...,) int32; uv/level:
    (..., 2). Non-finite uv/level are sanitized so the index stays in range.
    """
    lv = torch.nan_to_num(level, nan=256.0, posinf=256.0,
                          neginf=1.0).clamp(1.0, 256.0)
    lp = next_power_of_two(lv)
    frac = torch.fmod(torch.nan_to_num(uv), 1.0)
    t = trunc_i32(frac * lp)             # truncates toward zero like Swift Int()
    addr = t + (511 & ~(2 * lp - 1))     # Swift & binds at * precedence
    x = addr[..., 0].clamp(0, ATLAS_EDGE - 1).long()
    y = addr[..., 1].clamp(0, ATLAS_EDGE - 1).long()
    tex = tex_idx.clamp(0, max(num_textures - 1, 0)).long()
    return (tex * ATLAS_EDGE + y) * ATLAS_EDGE + x


def sample_ripmap(textures: torch.Tensor, tex_idx: torch.Tensor,
                  uv: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor anisotropic ripmap fetch.

    textures: (NT, 512, 512) int32; tex_idx: (...,) int32; uv/level: (..., 2).
    Returns (..., 3) float32 RGB in [0, 255].
    """
    rgb = textures.reshape(-1)[texel_index(tex_idx, uv, level,
                                           textures.shape[0])]
    return torch.stack(
        [(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF], dim=-1
    ).to(torch.float32)
