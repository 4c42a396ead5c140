"""The portable rasterizer: band-looped visibility resolve + deferred shading.

Counterpart of ``swift3drenderer_tpu.ops.raster_xla``, the JAX package's XLA
backend, in torch ops: the port's second backend (``Renderer(...,
backend="xla")``). No Pallas kernel stands behind the JAX module, so plain
torch is its port; the hand-written kernels are the ``"cuda"`` backend's.

The reference walks each triangle's bbox serially with incremental edge
functions (render/render.swift:320-342). Here coverage is evaluated for
*chunks of triangles at once* over *bands of pixel rows*, resolving the depth
test as a running max over 1/z (the reference's ``oneOverZ > depth`` test with
0-cleared depth, render.swift:323-325); then each pixel is shaded once from
its winning slot's setup row (deferred shading).

Tie behaviour matches the sequential reference and the JAX module: within a
chunk the lowest slot among equal maxima wins, across chunks only a strictly
greater 1/z replaces the winner, so the earlier slot keeps a tie. The result
depends on neither ``band_rows`` nor ``chunk``, and a band at ``y_offset``
equals the same rows of the whole frame.

Every sum is written out left to right and every product is its own op, so
the frame is the same bit for bit on the CPU and on the card (no contraction,
no reduction order to differ). The normalisations take the port's correctly
rounded ``ops.raster._rsqrt3``, not ``torch.rsqrt``, and the texel fetches
the port's ``ops.texture`` samplers; against the JAX module (whose CPU rsqrt
is not correctly rounded and whose sums XLA may contract) the frames agree
within the port's 5e-4 bound.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .raster import _check_sampling, _rsqrt3
from .texture import sample_ripmap, sample_ripmap_bilinear

_SETUP_KEYS = ("live", "w00", "dx", "dy", "rvz", "cvp", "np", "attrp", "tex",
               "is_tex", "tpp", "dzv", "xmin", "xmax", "ymin", "ymax")

_U32 = 2 ** 32


def _pad_setup(setup: Dict[str, torch.Tensor],
               multiple: int) -> Dict[str, torch.Tensor]:
    """The setup table padded with zero slots (``live`` False) to a multiple
    of ``multiple`` slots."""
    s = setup["live"].shape[0]
    pad = (-s) % multiple
    if pad == 0:
        return setup
    return {k: torch.cat([setup[k], setup[k].new_zeros((pad,) + tuple(
        setup[k].shape[1:]))]) for k in _SETUP_KEYS}


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 as XLA converts (toward zero, saturating, NaN -> 0),
    held in int64."""
    y = torch.nan_to_num(x, nan=0.0).clamp(min=0.0).to(torch.float64)
    return y.clamp(max=float(_U32 - 1)).to(torch.int64)


def _corner_sum(wt: torch.Tensor, per_corner: torch.Tensor) -> torch.Tensor:
    """sum_k wt[..., k] * per_corner[..., k, :] over the three corners, left
    to right: (..., 3)."""
    return (wt[..., 0:1] * per_corner[..., 0, :]
            + wt[..., 1:2] * per_corner[..., 1, :]
            + wt[..., 2:3] * per_corner[..., 2, :])


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v * _rsqrt3(v[..., 0], v[..., 1], v[..., 2])[..., None]


def shade_pixels(win: torch.Tensor, ooz: torch.Tensor, px: torch.Tensor,
                 py: torch.Tensor, setup: Dict[str, torch.Tensor],
                 textures: torch.Tensor, background: int,
                 sampling: str = "nearest") -> torch.Tensor:
    """Deferred shading (render.swift:326-331 + texture path :312-316) of
    every pixel from its winner: ``win`` (...) int32 winning slot, -1 =
    background; ``ooz`` its 1/z; ``px``/``py`` the pixel's float32 column
    and row. Returns packed 0x00RRGGBB pixels (...) int32."""
    wid = win.clamp(min=0).long()

    def g(k):
        return setup[k][wid]

    w = g("w00") + px[..., None] * g("dx") + py[..., None] * g("dy")
    wt = w / ooz[..., None]          # perspective-correct weights w / (1/z)

    point = -_normalize(_corner_sum(wt, g("cvp")))
    normal = _normalize(_corner_sum(wt, g("np")))
    halfway = _normalize(point + normal)
    shade = (halfway[..., 0] * normal[..., 0] + halfway[..., 1] * normal[..., 1]
             + halfway[..., 2] * normal[..., 2])

    interp = _corner_sum(wt, g("attrp"))             # (..., 3)
    mapping = interp[..., :2]
    level = ooz[..., None] / torch.abs(g("tpp") - mapping * g("dzv"))
    if textures.shape[0]:
        sampler = (sample_ripmap_bilinear if sampling == "bilinear"
                   else sample_ripmap)
        tex_color = sampler(textures, g("tex"), mapping, level)
    else:
        tex_color = torch.zeros_like(interp)
    color = torch.where(g("is_tex")[..., None], tex_color, interp)

    shaded = shade[..., None] * color
    packed = ((_to_u32(shaded[..., 0]) << 16) | (_to_u32(shaded[..., 1]) << 8)
              | _to_u32(shaded[..., 2])) & (_U32 - 1)
    packed = torch.where(packed >= 2 ** 31, packed - _U32, packed).to(torch.int32)
    return torch.where(win < 0, background, packed)


def rasterize(setup: Dict[str, torch.Tensor], textures: torch.Tensor, *,
              width: int, height: int, background: int, band_rows: int = 32,
              chunk: int = 16, y_offset: int = 0, sampling: str = "nearest"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize one frame's setup table (S slots, no batch axis): (pixels
    (H, W) int32 holding 0x00RRGGBB, depth (H, W) f32).

    ``height`` rows starting at framebuffer row ``y_offset`` are produced
    (the band of a sharded frame). Memory is bounded to a few (chunk,
    band_rows, W) planes at a time. The loops are over Python ints, so the
    frame reads nothing back from the device and can be captured in a CUDA
    graph."""
    _check_sampling(sampling)
    if setup["live"].dim() != 1:
        raise ValueError("raster_xla.rasterize takes one frame's table; "
                         f"got live {tuple(setup['live'].shape)}")
    device = setup["live"].device
    setup = _pad_setup(setup, chunk)
    s = setup["live"].shape[0]
    nchunks = s // chunk
    nbands = -(-height // band_rows)
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    pxi = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    lane = torch.arange(chunk, dtype=torch.int32, device=device)[:, None, None]

    def col(k, c, j=None):      # chunk c of key k (corner j) as (chunk, 1, 1)
        v = setup[k][c * chunk:(c + 1) * chunk]
        return (v if j is None else v[:, j])[:, None, None]

    pix_bands, depth_bands = [], []
    for b in range(nbands):
        y0 = y_offset + b * band_rows
        py = (y0 + torch.arange(band_rows, dtype=torch.int32,
                                device=device))[:, None]        # (band, 1)
        pyf = py.to(torch.float32)
        best = torch.zeros((band_rows, width), dtype=torch.float32,
                           device=device)
        win = torch.full((band_rows, width), -1, dtype=torch.int32,
                         device=device)
        for c in range(nchunks):
            # w_j = w00 + px * dx + py * dy for corner j of each slot of the
            # chunk at pixel (i, y0 + row); the +0.5 centers are in w00.
            w = [col("w00", c, j) + px[None] * col("dx", c, j)
                 + pyf[None] * col("dy", c, j) for j in range(3)]
            inside = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)
            in_bbox = ((pxi[None] >= col("xmin", c)) & (pxi[None] <= col("xmax", c))
                       & (py[None] >= col("ymin", c)) & (py[None] <= col("ymax", c)))
            cover = inside & in_bbox & col("live", c)
            ooz = (w[0] * col("rvz", c, 0) + w[1] * col("rvz", c, 1)
                   + w[2] * col("rvz", c, 2))
            ooz = torch.where(cover, ooz, 0.0)
            cbest = ooz.amax(dim=0)
            # The lowest slot of the chunk holding the maximum.
            first = torch.where(ooz == cbest, lane, chunk).amin(dim=0)
            cwin = c * chunk + first.clamp(max=chunk - 1)
            upd = cbest > best          # strict: the earlier slot keeps a tie
            best = torch.where(upd, cbest, best)
            win = torch.where(upd, cwin, win)
        pix_bands.append(shade_pixels(
            win, best, px.expand(band_rows, width),
            pyf.expand(band_rows, width), setup, textures, background,
            sampling=sampling))
        depth_bands.append(best)
    pixels = torch.cat(pix_bands)[:height]
    depth = torch.cat(depth_bands)[:height]
    return pixels, depth
