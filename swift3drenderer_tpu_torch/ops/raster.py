"""Tiled rasterizer: binning, packed setup tables, and the four CUDA kernels
``raster_flat_nearest``, ``raster_flat_bilinear``,
``raster_segmented_nearest`` and ``raster_segmented_bilinear``, each with its
plain PyTorch version.

Counterpart of ``swift3drenderer_tpu.ops.raster_pallas``:
``pack_setup_tables``, ``bin_triangles``, ``bin_segments``,
``_rasterize_chunk`` and the ``_raster_kernel`` it launches, with nearest or
bilinear sampling. The frame is cut into TILE_W x TILE_H pixel tiles. Small
scenes (at most FLAT_MAX_SLOTS slots) bin flat: each tile's list holds, in
ascending order, the live slots whose bbox touches it. Larger scenes bin in
segments: a tile walks its own segment of one sorted (tile, slot) entry array
and the broadband slots whose bbox touches it. Each kernel (csrc/raster.cu)
runs one thread block per tile and frame and one thread per pixel:
visibility over the tile's lists, then the winner's shading and texel fetch,
all in one launch as on the TPU, for any scene size.

Camera batches. Every function here takes an optional leading batch axis B
on its per-frame inputs (setup arrays (B, S, ...), tables (B, 43, S), ...)
and then returns per-frame outputs with the same leading axis: one launch
renders B frames (the JAX package's (B, nty, ntx) grid), and frame b's
tables, bins and pixels equal those of frame b rendered alone. Without the
axis a call is one frame.

Winners do not depend on the tiling: a pixel tests every live slot whose bbox
touches its tile, and the exact bbox test is part of coverage, so any slot left
out of a tile's list would fail it anyway. The flat plain version therefore
walks all binned slots over the whole frame.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from .. import kernels
from .setup import trunc_i32
from .texture import bilinear_taps, sample_ripmap, sample_ripmap_bilinear, texel_index

# Row indices of the packed (43, S) float32 table (raster_pallas.py:54-58).
_W00, _DX, _DY, _RVZ = 0, 3, 6, 9          # 3 rows each: barycentric + 1/z
_CVP, _NP, _ATTRP = 12, 21, 30             # 9 rows each: corner-major premultiplied
_TPP, _DZV = 39, 41                        # 2 rows each: ripmap level constants
_F32_ROWS = 43
# Row indices of the packed (7, S) int32 table (raster_pallas.py:63-64).
# _GID is each slot's global setup index.
_XMIN, _XMAX, _YMIN, _YMAX, _TEXBASE, _ISTEX, _GID = 0, 1, 2, 3, 4, 5, 6
_I32_ROWS = 7

SAMPLINGS = ("nearest", "bilinear")

# The port's pixel tile: one warp spans one 32-pixel row, so output stores
# coalesce; 1080 and 2160 are multiples of 8, so the common frames have no
# ragged tiles. Thread block = one tile; csrc/raster.cu fixes the same shape
# (kTileW, kTileH).
TILE_W, TILE_H = 32, 8

# Scenes of at most FLAT_MAX_SLOTS slots take the flat kernels; larger ones
# the segmented front-end and kernels. The same scenes take the same form in
# the JAX package (S + 3 <= 128, raster_pallas.py:1477; its other condition,
# B * ntiles <= 512, answers the TPU's SMEM and does not change winners).
FLAT_MAX_SLOTS = 125

# Tiles a slot's bbox may cover before the segmented binner sends it to the
# broadband list instead of giving it one entry per tile. Larger K sorts more
# entries (K * S keys); smaller K sends more slots to the broadband list,
# whose bboxes every tile tests. 16 gave the least device time (sort +
# kernel) summed over stress 840 at 1080p and 4K and stress100k at 1080p
# (chip_smoke.py's K sweep; PERF.md).
SEG_K = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_setup_tables(setup: Dict[str, torch.Tensor]):
    """Pack the setup table into (row, slot) arrays: (..., 43, S) f32 and
    (..., 7, S) i32. Row _GID holds each slot's own index (one pass covers
    the whole table)."""
    live = setup["live"]
    n = live.shape[-1]

    def rows(x, k):
        return x.reshape(*live.shape, k).transpose(-1, -2)

    f32 = torch.cat([
        rows(setup["w00"], 3), rows(setup["dx"], 3), rows(setup["dy"], 3),
        rows(setup["rvz"], 3), rows(setup["cvp"], 9), rows(setup["np"], 9),
        rows(setup["attrp"], 9), rows(setup["tpp"], 2), rows(setup["dzv"], 2),
    ], dim=-2).to(torch.float32).contiguous()             # (..., 43, S)
    i32 = torch.stack([
        setup["xmin"], setup["xmax"], setup["ymin"], setup["ymax"],
        torch.where(setup["is_tex"], setup["tex"] << 18, -1),
        setup["is_tex"].to(torch.int32),
        torch.arange(n, dtype=torch.int32, device=live.device).expand(live.shape),
    ], dim=-2).to(torch.int32).contiguous()               # (..., 7, S)
    return f32, i32


def _tile_bbox(setup: Dict[str, torch.Tensor], ntx: int, nty: int,
               tile_w: int, tile_h: int):
    """Each slot's bbox in tile coordinates, clamped to the grid:
    (txmin, txmax, tymin, tymax), (..., S) int32 each."""
    def tiles(v, size, n):
        return torch.clamp(torch.div(v, size, rounding_mode="floor"), 0, n - 1)

    return (tiles(setup["xmin"], tile_w, ntx), tiles(setup["xmax"], tile_w, ntx),
            tiles(setup["ymin"], tile_h, nty), tiles(setup["ymax"], tile_h, nty))


def bin_triangles(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                  tile_h: int, tile_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map each live triangle to the framebuffer tiles its bbox touches.

    Returns (ids (..., ntiles, S) int32 — touching triangle slots first,
    ascending; counts (..., ntiles, 1) int32). Ascending id order preserves
    the reference's earlier-triangle-wins depth ties.
    """
    live = setup["live"]
    dev = live.device
    ntx, nty = _cdiv(width, tile_w), _cdiv(height, tile_h)
    txmin, txmax, tymin, tymax = _tile_bbox(setup, ntx, nty, tile_w, tile_h)
    tx = torch.arange(ntx, dtype=torch.int32, device=dev)
    ty = torch.arange(nty, dtype=torch.int32, device=dev)
    touch_x = (tx >= txmin[..., None]) & (tx <= txmax[..., None])
    touch_y = (ty >= tymin[..., None]) & (ty <= tymax[..., None])
    # A live slot's bbox lies inside the frame (triangle_setup clamps it), so
    # unlike the banded JAX binner no row-band test is needed.
    touch = ((touch_y[..., :, None] & touch_x[..., None, :])
             & live[..., None, None])
    touch = touch.flatten(-2).transpose(-1, -2)             # (..., ntiles, S)
    s = touch.shape[-1]
    # Stable partition (touching slots first, both groups ascending) as a
    # sort of one unique key: untouched slots get their index + S.
    slot = torch.arange(s, dtype=torch.int32, device=dev)
    keys = torch.where(touch, slot, slot + s)
    ids = (torch.sort(keys, dim=-1).values % s).to(torch.int32).contiguous()
    counts = touch.sum(dim=-1, dtype=torch.int32)[..., None].contiguous()
    return ids, counts


def segment_keys(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                 k: int = SEG_K) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unsorted entries of ``bin_segments``: (keys (..., S*K) int32, big
    (..., S) bool). Entry ``slot * K + e`` is the e-th tile, row-major, of
    the slot's tile bbox, keyed by that tile's index, for each live slot
    whose bbox covers at most K tiles; every other entry is keyed ``ntiles``,
    past every tile. ``big`` marks the live slots that cover more than K
    tiles. A key is at most ``ntiles``, so it is bounded by the grid alone,
    whatever S."""
    ntx, nty = _cdiv(width, TILE_W), _cdiv(height, TILE_H)
    txmin, txmax, tymin, tymax = _tile_bbox(setup, ntx, nty, TILE_W, TILE_H)
    live = setup["live"]
    # Dead slots may have an empty bbox; clamping keeps the division defined.
    wx = (txmax - txmin + 1).clamp(min=1)
    area = wx * (tymax - tymin + 1)
    small = live & (area <= k)
    e = torch.arange(k, dtype=torch.int32, device=live.device)
    dy = torch.div(e, wx[..., None], rounding_mode="floor")
    tile = (tymin[..., None] + dy) * ntx + txmin[..., None] + (e - dy * wx[..., None])
    keys = torch.where(small[..., None] & (e < area[..., None]), tile, ntx * nty)
    return keys.flatten(-2).to(torch.int32), live & (area > k)


def bin_segments(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                 k: int = SEG_K):
    """Segmented binning at TILE_W x TILE_H: the large-scene front-end
    (``raster_pallas.py::bin_segments``).

    Each live slot whose bbox covers at most K tiles gives one (tile, slot)
    entry per covered tile; one stable sort of the tile keys, slot-major,
    groups the entries by tile with ascending slots within each tile. Slots
    covering more tiles go to one shared ascending broadband list. Every
    shape is static (K*S entries per frame) and nothing is read back to the
    host, so a frame makes no device-to-host copy. A batch sorts once: frame
    b's keys are offset by b * (ntiles + 1), so its entries keep their order
    and land in its own K*S positions.

    Returns (ids (..., K*S) int32: entry slots, tile-major, the tail past the
    last segment unused; starts (..., ntiles) int32 and counts (...,
    ntiles) int32: each tile's segment of its frame's ``ids``; bb (..., S)
    int32: the broadband slots ascending, then the other slots; bb_count
    (..., 1) int32: the broadband list's length).
    """
    keys, big = segment_keys(setup, width=width, height=height, k=k)
    dev = keys.device
    lead, s = big.shape[:-1], big.shape[-1]
    keys = keys.reshape(-1, s * k)
    ntiles = _cdiv(width, TILE_W) * _cdiv(height, TILE_H)
    frame = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)[:, None]
    sorted_keys, order = torch.sort((keys + frame * (ntiles + 1)).reshape(-1),
                                    stable=True)
    ids = (torch.div(order, k, rounding_mode="floor") % s).to(torch.int32)
    targets = frame * (ntiles + 1) + torch.arange(ntiles + 1, dtype=torch.int32,
                                                  device=dev)
    bounds = torch.searchsorted(sorted_keys, targets.reshape(-1),
                                out_int32=True).reshape(-1, ntiles + 1)
    starts = bounds[:, :-1] - frame * (s * k)
    counts = bounds[:, 1:] - bounds[:, :-1]
    slot = torch.arange(s, dtype=torch.int32, device=dev)
    bb = (torch.sort(torch.where(big, slot, slot + s), dim=-1).values % s
          ).to(torch.int32)
    return (ids.reshape(*lead, s * k), starts.reshape(*lead, ntiles).contiguous(),
            counts.reshape(*lead, ntiles).contiguous(), bb,
            big.sum(dim=-1, dtype=torch.int32)[..., None])


# ---------------------------------------------------------------------------
# The plain PyTorch versions of the flat kernels.

def _binned_slots(counts: torch.Tensor, ids: torch.Tensor) -> list:
    """Ascending list of every slot some tile's list holds (one frame)."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return torch.unique(ids[pos < counts]).tolist()


def visibility_plain(counts: torch.Tensor, ids: torch.Tensor,
                     trf: torch.Tensor, tri: torch.Tensor, *, width: int,
                     height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of one frame over the whole frame: (best 1/z (H, W) f32,
    winner slot (H, W) i32, -1 where nothing covers). Slots are walked in
    ascending order with the strict ``>`` update, so the earlier slot keeps a
    depth tie (render.swift:323-325)."""
    dev = trf.device
    pyi = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    pxi = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    pyf, pxf = pyi.to(torch.float32), pxi.to(torch.float32)
    best = torch.zeros((height, width), dtype=torch.float32, device=dev)
    win = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    slots = _binned_slots(counts, ids)
    if not slots:
        return best, win
    fcol = trf[:, slots].T.tolist()      # exact f32 values as Python floats
    icol = tri[:, slots].T.tolist()
    for s, f, i in zip(slots, fcol, icol):
        w0 = f[_W00 + 0] + pxf * f[_DX + 0] + pyf * f[_DY + 0]
        w1 = f[_W00 + 1] + pxf * f[_DX + 1] + pyf * f[_DY + 1]
        w2 = f[_W00 + 2] + pxf * f[_DX + 2] + pyf * f[_DY + 2]
        cover = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                 & (pxi >= i[_XMIN]) & (pxi <= i[_XMAX])
                 & (pyi >= i[_YMIN]) & (pyi <= i[_YMAX]))
        ooz = w0 * f[_RVZ + 0] + w1 * f[_RVZ + 1] + w2 * f[_RVZ + 2]
        ooz = torch.where(cover, ooz, 0.0)
        upd = ooz > best                  # strict: earlier slot wins depth ties
        best = torch.where(upd, ooz, best)
        win = torch.where(upd, s, win)
    return best, win


def _pack(sh, r, g, b):
    """Shade-scaled channels packed 0x00RRGGBB by int32 truncation
    (render.swift:84-87, 330)."""
    return ((trunc_i32(sh * r) << 16) | (trunc_i32(sh * g) << 8)
            | trunc_i32(sh * b))


def _rsqrt3(x, y, z):
    return 1.0 / torch.sqrt(x * x + y * y + z * z)


def _shade_winners(best: torch.Tensor, win: torch.Tensor, trf: torch.Tensor,
                   tri: torch.Tensor):
    """Phase 2 for every pixel of one frame that has a winner:
    perspective-correct weights, halfway-vector headlight and the flat color
    pack. Returns (pixel rows, pixel columns, shade, packs, textured mask)
    over those pixels, and the inputs of phase 3's texel fetch over the
    textured ones: (texture index, uv (n, 2), ripmap level (n, 2))."""
    yy, xx = torch.nonzero(win >= 0, as_tuple=True)
    s = win[yy, xx].long()
    pxf, pyf = xx.to(torch.float32), yy.to(torch.float32)
    b = best[yy, xx]

    def col(row):
        return trf[row][s]

    inv = 1.0 / b
    t0, t1, t2 = ((col(_W00 + k) + pxf * col(_DX + k) + pyf * col(_DY + k))
                  * inv for k in range(3))

    def interp3(base):
        return tuple(col(base + k) * t0 + col(base + 3 + k) * t1
                     + col(base + 6 + k) * t2 for k in range(3))

    # Halfway-vector headlight (render.swift:327-330).
    px_, py_, pz_ = interp3(_CVP)
    pn = -_rsqrt3(px_, py_, pz_)
    px_, py_, pz_ = px_ * pn, py_ * pn, pz_ * pn
    nx, ny, nz = interp3(_NP)
    nn = _rsqrt3(nx, ny, nz)
    nx, ny, nz = nx * nn, ny * nn, nz * nn
    hx, hy, hz = px_ + nx, py_ + ny, pz_ + nz
    hn = _rsqrt3(hx, hy, hz)
    sh = (hx * nx + hy * ny + hz * nz) * hn
    cr, cg, cb = interp3(_ATTRP)

    # Textured winners: (cr, cg) is the perspective-correct (u, v); anisotropic
    # ripmap level per axis (render.swift:94-111).
    tx = tri[_ISTEX][s] != 0
    u, v, bt, st = cr[tx], cg[tx], b[tx], s[tx]
    level = torch.stack(
        [bt / torch.abs(trf[_TPP][st] - u * trf[_DZV][st]),
         bt / torch.abs(trf[_TPP + 1][st] - v * trf[_DZV + 1][st])], dim=-1)
    return (yy, xx, sh, _pack(sh, cr, cg, cb), tx,
            tri[_TEXBASE][st] >> 18, torch.stack([u, v], dim=-1), level)


def _check_sampling(sampling: str) -> None:
    if sampling not in SAMPLINGS:
        raise ValueError(f"sampling={sampling!r}: the kernels sample "
                         f"{' or '.join(SAMPLINGS)}")


def shade_plain(best: torch.Tensor, win: torch.Tensor, trf: torch.Tensor,
                tri: torch.Tensor, textures: torch.Tensor, *, background: int,
                sampling: str = "nearest") -> torch.Tensor:
    """Phases 2 and 3 for every pixel of one frame that has a winner: the flat
    color pack, or the nearest or bilinear texel fetch and shade multiply.
    Background elsewhere. Returns packed pixels (H, W) int32."""
    _check_sampling(sampling)
    pix = torch.full(best.shape, background, dtype=torch.int32,
                     device=best.device)
    yy, xx, sh, out, tx, tex, uv, level = _shade_winners(best, win, trf, tri)
    if bool(tx.any()):
        sample = sample_ripmap if sampling == "nearest" else sample_ripmap_bilinear
        rgb = sample(textures, tex, uv, level)
        out[tx] = _pack(sh[tx], rgb[:, 0], rgb[:, 1], rgb[:, 2])
    pix[yy, xx] = out
    return pix


def fetched_texels(best: torch.Tensor, win: torch.Tensor, trf: torch.Tensor,
                   tri: torch.Tensor, num_textures: int,
                   sampling: str = "nearest") -> torch.Tensor:
    """The distinct atlas words one frame's textured winners fetch (one per
    winner for nearest, four taps for bilinear), as ascending flat indices
    into ``textures.reshape(-1)``: what the kernel must read of the atlas."""
    _check_sampling(sampling)
    *_, tex, uv, level = _shade_winners(best, win, trf, tri)
    if sampling == "nearest":
        return torch.unique(texel_index(tex, uv, level, num_textures))
    return torch.unique(bilinear_taps(tex, uv, level, num_textures)[0])


def _over_frames(frame, per_frame, trf):
    """``frame`` over each frame of the ``per_frame`` inputs, which carry a
    leading batch axis when the table ``trf`` does ((B, 43, S)); the outputs
    are stacked on the same axis."""
    if trf.dim() == 2:
        return frame(*per_frame)
    outs = [frame(*(t[b] for t in per_frame)) for b in range(trf.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def raster_flat_plain(counts, ids, trf, tri, textures, *, width: int,
                      height: int, background: int, sampling: str):
    """Plain PyTorch version of the flat kernels: same inputs, same (pixels
    (..., H, W) int32, depth (..., H, W) f32)."""
    def frame(c, i, f, t):
        best, win = visibility_plain(c, i, f, t, width=width, height=height)
        return shade_plain(best, win, f, t, textures, background=background,
                           sampling=sampling), best

    return _over_frames(frame, (counts, ids, trf, tri), trf)


def raster_flat_nearest_plain(counts, ids, trf, tri, textures, *, width: int,
                              height: int, background: int):
    """Plain PyTorch version of ``raster_flat_nearest``."""
    return raster_flat_plain(counts, ids, trf, tri, textures, width=width,
                             height=height, background=background,
                             sampling="nearest")


def raster_flat_bilinear_plain(counts, ids, trf, tri, textures, *, width: int,
                               height: int, background: int):
    """Plain PyTorch version of ``raster_flat_bilinear``."""
    return raster_flat_plain(counts, ids, trf, tri, textures, width=width,
                             height=height, background=background,
                             sampling="bilinear")


# ---------------------------------------------------------------------------
# The plain PyTorch versions of the segmented kernels.

# (tile, slot) pairs evaluated at once by the plain segmented visibility: each
# pair is one tile's TILE_W x TILE_H pixels.
_PAIR_CHUNK = 8192
_I32_MAX_KEY = (1 << 31) - 1


def segmented_pairs(ids, starts, counts, bb, bb_count, tri, *, width: int,
                    height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (tile, slot) pair the segmented kernel evaluates and may let win
    in one frame: each tile's segment, and each broadband slot with every
    tile its bbox touches. Returns (tiles, slots), int64 (n,) each. Reads
    counts back to the host: for the plain version and measurements only."""
    dev = ids.device
    ntx, nty = _cdiv(width, TILE_W), _cdiv(height, TILE_H)
    counts = counts.long()
    seg_tiles = torch.repeat_interleave(
        torch.arange(ntx * nty, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts         # each segment's own start
    pos = (starts.long()[seg_tiles]
           + torch.arange(seg_tiles.numel(), device=dev) - first[seg_tiles])
    seg_slots = ids.long()[pos]
    big = bb[:int(bb_count.reshape(-1)[0])].long()
    bbox = {"xmin": tri[_XMIN], "xmax": tri[_XMAX], "ymin": tri[_YMIN],
            "ymax": tri[_YMAX]}
    x0, x1, y0, y1 = (v[big].long() for v in _tile_bbox(bbox, ntx, nty,
                                                        TILE_W, TILE_H))
    wx = x1 - x0 + 1
    area = wx * (y1 - y0 + 1)
    bb_slots = torch.repeat_interleave(big, area)
    j = (torch.arange(bb_slots.numel(), device=dev)
         - torch.repeat_interleave(torch.cumsum(area, 0) - area, area))
    wx, x0, y0 = (torch.repeat_interleave(v, area) for v in (wx, x0, y0))
    bb_tiles = (y0 + j // wx) * ntx + x0 + j % wx
    return torch.cat([seg_tiles, bb_tiles]), torch.cat([seg_slots, bb_slots])


def visibility_segmented_plain(ids, starts, counts, bb, bb_count, trf, tri, *,
                               width: int, height: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the segmented kernels over one whole frame: (best 1/z
    (H, W) f32, winner slot (H, W) i32, -1 where nothing covers).

    Every (tile, slot) pair of ``segmented_pairs`` is evaluated over the
    tile's pixels, in chunks, with each edge function rounded as
    ``(w00 + px*dx) + py*dy`` as the kernel rounds it. A pixel's winner is the
    order-independent rule of raster_pallas.py:463-471 — the greatest 1/z,
    and at equal 1/z > 0 the smaller slot — taken by one ``amax`` over the
    int64 key ``bits(1/z) << 32 | (2^31 - 1 - slot)``: positive f32 bit
    patterns order as the floats do, and 1/z <= 0 (or NaN) never wins."""
    dev = trf.device
    ntx = _cdiv(width, TILE_W)
    tiles, slots = segmented_pairs(ids, starts, counts, bb, bb_count, tri,
                                   width=width, height=height)
    lane = torch.arange(TILE_W * TILE_H, device=dev)
    lx, ly = lane % TILE_W, lane // TILE_W
    key = torch.zeros(height * width, dtype=torch.int64, device=dev)
    for c in range(0, tiles.numel(), _PAIR_CHUNK):
        t, s = tiles[c:c + _PAIR_CHUNK], slots[c:c + _PAIR_CHUNK]
        px = (t % ntx * TILE_W)[:, None] + lx[None, :]
        py = (t // ntx * TILE_H)[:, None] + ly[None, :]
        pxf, pyf = px.to(torch.float32), py.to(torch.float32)
        f, i = trf[:, s, None], tri[:, s, None]
        w0, w1, w2 = (f[_W00 + k] + pxf * f[_DX + k] + pyf * f[_DY + k]
                      for k in range(3))
        ooz = w0 * f[_RVZ] + w1 * f[_RVZ + 1] + w2 * f[_RVZ + 2]
        wins = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (ooz > 0)
                & (px >= i[_XMIN]) & (px <= i[_XMAX])
                & (py >= i[_YMIN]) & (py <= i[_YMAX])
                & (px < width) & (py < height))
        k = ((ooz.view(torch.int32).to(torch.int64) << 32)
             | (_I32_MAX_KEY - s)[:, None])
        key.scatter_reduce_(0, torch.where(wins, py * width + px, 0).reshape(-1),
                            torch.where(wins, k, 0).reshape(-1), reduce="amax")
    best = (key >> 32).to(torch.int32).view(torch.float32).reshape(height, width)
    win = torch.where(key > 0, _I32_MAX_KEY - (key & _I32_MAX_KEY), -1)
    return best, win.to(torch.int32).reshape(height, width)


def raster_segmented_plain(ids, starts, counts, bb, bb_count, trf, tri,
                           textures, *, width: int, height: int,
                           background: int, sampling: str):
    """Plain PyTorch version of the segmented kernels: same inputs, same
    (pixels (..., H, W) int32, depth (..., H, W) f32)."""
    def frame(i, st, c, b, n, f, t):
        best, win = visibility_segmented_plain(i, st, c, b, n, f, t,
                                               width=width, height=height)
        return shade_plain(best, win, f, t, textures, background=background,
                           sampling=sampling), best

    return _over_frames(frame, (ids, starts, counts, bb, bb_count, trf, tri),
                        trf)


def raster_segmented_nearest_plain(ids, starts, counts, bb, bb_count, trf, tri,
                                   textures, *, width: int, height: int,
                                   background: int):
    """Plain PyTorch version of ``raster_segmented_nearest``."""
    return raster_segmented_plain(ids, starts, counts, bb, bb_count, trf, tri,
                                  textures, width=width, height=height,
                                  background=background, sampling="nearest")


def raster_segmented_bilinear_plain(ids, starts, counts, bb, bb_count, trf,
                                    tri, textures, *, width: int, height: int,
                                    background: int):
    """Plain PyTorch version of ``raster_segmented_bilinear``."""
    return raster_segmented_plain(ids, starts, counts, bb, bb_count, trf, tri,
                                  textures, width=width, height=height,
                                  background=background, sampling="bilinear")


# ---------------------------------------------------------------------------
# The kernels' wrappers.

@functools.cache
def _kernel(name: str, pointers: int, ints: int):
    """The C entry point ``name``: ``pointers`` device pointers, then
    ``ints`` ints (B, S, [entries per frame,] the texture count, width,
    height and background), then the stream."""
    fn = getattr(kernels.library(), name)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _frame_dims(trf: torch.Tensor):
    """(leading batch dims, () or (B,); S) of a (..., 43, S) table. The
    kernels index the batch's tables with 32-bit offsets."""
    if trf.dim() not in (2, 3):
        raise ValueError(f"trf: need (43, S) or (B, 43, S), got {tuple(trf.shape)}")
    if trf.numel() >= 2 ** 31:
        raise ValueError(f"trf: {trf.numel()} words, past one launch's 2^31; "
                         "render the batch in smaller batches")
    return tuple(trf.shape[:-2]), trf.shape[-1]


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(name: str, inputs, textures: torch.Tensor, lead, ints, *,
            width: int, height: int, background: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the (..., H, W) outputs and launch ``name`` on the tensors'
    card over a (ntx, nty, B) grid; raise if the launch was refused."""
    dev = textures.device
    pix = torch.empty((*lead, height, width), dtype=torch.int32, device=dev)
    depth = torch.empty((*lead, height, width), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (*inputs, textures, pix, depth)]
    ints = (math.prod(lead), *ints, textures.shape[0], width, height,
            background)
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _kernel(name, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {kernels.error_string(err)}")
    return pix, depth


def _raster_flat(wrapper, sampling, counts, ids, trf, tri, textures, *,
                 width, height, background):
    kw = dict(width=width, height=height, background=background)
    dev = trf.device
    if dev.type == "cpu":
        return raster_flat_plain(counts, ids, trf, tri, textures,
                                 sampling=sampling, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {dev}")
    lead, s = _frame_dims(trf)
    ntiles = _cdiv(width, TILE_W) * _cdiv(height, TILE_H)
    _check(counts, "counts", torch.int32, (*lead, ntiles, 1), dev)
    _check(ids, "ids", torch.int32, (*lead, ntiles, s), dev)
    _check(trf, "trf", torch.float32, (*lead, _F32_ROWS, s), dev)
    _check(tri, "tri", torch.int32, (*lead, _I32_ROWS, s), dev)
    _check(textures, "textures", torch.int32,
           (textures.shape[0], 512, 512), dev)
    out = _launch(wrapper.__name__, (counts, ids, trf, tri), textures, lead,
                  (s,), **kw)
    wrapper.launches += 1
    return out


def raster_flat_nearest(counts: torch.Tensor, ids: torch.Tensor,
                        trf: torch.Tensor, tri: torch.Tensor,
                        textures: torch.Tensor, *, width: int, height: int,
                        background: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility, deferred shading and nearest texel fetch for one frame or
    a batch, in one launch.

    counts (..., ntiles, 1) i32 and ids (..., ntiles, S) i32 from
    ``bin_triangles`` at TILE_W x TILE_H; trf (..., 43, S) f32 and tri (...,
    7, S) i32 from ``pack_setup_tables``; textures (NT, 512, 512) i32, shared
    by every frame. The leading axis, where present, is the batch B. Returns
    (pixels (..., H, W) int32 holding 0x00RRGGBB, depth (..., H, W) f32 =
    1/z, 0 where empty).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``raster_flat_nearest.launches`` counts the kernel's launches.
    """
    return _raster_flat(raster_flat_nearest, "nearest", counts, ids, trf, tri,
                        textures, width=width, height=height,
                        background=background)


def raster_flat_bilinear(counts: torch.Tensor, ids: torch.Tensor,
                         trf: torch.Tensor, tri: torch.Tensor,
                         textures: torch.Tensor, *, width: int, height: int,
                         background: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raster_flat_nearest`` with the bilinear texel fetch: the four taps
    of ``ops.texture.bilinear_taps``, blended as float channels before the
    shade multiply. ``raster_flat_bilinear.launches`` counts its launches."""
    return _raster_flat(raster_flat_bilinear, "bilinear", counts, ids, trf,
                        tri, textures, width=width, height=height,
                        background=background)


def _raster_segmented(wrapper, sampling, ids, starts, counts, bb, bb_count,
                      trf, tri, textures, *, width, height, background):
    kw = dict(width=width, height=height, background=background)
    dev = trf.device
    if dev.type == "cpu":
        return raster_segmented_plain(ids, starts, counts, bb, bb_count, trf,
                                      tri, textures, sampling=sampling, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {dev}")
    lead, s = _frame_dims(trf)
    ntiles = _cdiv(width, TILE_W) * _cdiv(height, TILE_H)
    entries = ids.shape[-1]
    _check(ids, "ids", torch.int32, (*lead, entries), dev)
    _check(starts, "starts", torch.int32, (*lead, ntiles), dev)
    _check(counts, "counts", torch.int32, (*lead, ntiles), dev)
    _check(bb, "bb", torch.int32, (*lead, s), dev)
    _check(bb_count, "bb_count", torch.int32, (*lead, 1), dev)
    _check(trf, "trf", torch.float32, (*lead, _F32_ROWS, s), dev)
    _check(tri, "tri", torch.int32, (*lead, _I32_ROWS, s), dev)
    _check(textures, "textures", torch.int32,
           (textures.shape[0], 512, 512), dev)
    out = _launch(wrapper.__name__, (ids, starts, counts, bb, bb_count, trf, tri),
                  textures, lead, (s, entries), **kw)
    wrapper.launches += 1
    return out


def raster_segmented_nearest(ids: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, bb: torch.Tensor,
                             bb_count: torch.Tensor, trf: torch.Tensor,
                             tri: torch.Tensor, textures: torch.Tensor, *,
                             width: int, height: int, background: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility over each tile's segment and the broadband list, deferred
    shading and nearest texel fetch for one frame or a batch, in one launch.

    ids (..., E) i32, starts (..., ntiles) i32, counts (..., ntiles) i32, bb
    (..., S) i32 and bb_count (..., 1) i32 from ``bin_segments``; trf (...,
    43, S) f32 and tri (..., 7, S) i32 from ``pack_setup_tables``; textures
    (NT, 512, 512) i32, shared by every frame. The leading axis, where
    present, is the batch B. Returns (pixels (..., H, W) int32 holding
    0x00RRGGBB, depth (..., H, W) f32 = 1/z, 0 where empty), equal to
    ``raster_flat_nearest`` on the same setup table.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``raster_segmented_nearest.launches`` counts the kernel's launches.
    """
    return _raster_segmented(raster_segmented_nearest, "nearest", ids, starts,
                             counts, bb, bb_count, trf, tri, textures,
                             width=width, height=height, background=background)


def raster_segmented_bilinear(ids: torch.Tensor, starts: torch.Tensor,
                              counts: torch.Tensor, bb: torch.Tensor,
                              bb_count: torch.Tensor, trf: torch.Tensor,
                              tri: torch.Tensor, textures: torch.Tensor, *,
                              width: int, height: int, background: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raster_segmented_nearest`` with the bilinear texel fetch, equal to
    ``raster_flat_bilinear`` on the same setup table.
    ``raster_segmented_bilinear.launches`` counts its launches."""
    return _raster_segmented(raster_segmented_bilinear, "bilinear", ids, starts,
                             counts, bb, bb_count, trf, tri, textures,
                             width=width, height=height, background=background)


for _wrapper in (raster_flat_nearest, raster_flat_bilinear,
                 raster_segmented_nearest, raster_segmented_bilinear):
    _wrapper.launches = 0

_FLAT = {"nearest": raster_flat_nearest, "bilinear": raster_flat_bilinear}
_SEGMENTED = {"nearest": raster_segmented_nearest,
              "bilinear": raster_segmented_bilinear}


def rasterize(setup: Dict[str, torch.Tensor], textures: torch.Tensor, *,
              width: int, height: int, background: int,
              sampling: str = "nearest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin, pack and rasterize one frame, or a batch (setup arrays with a
    leading B), in one kernel launch: (pixels (..., H, W) int32, depth (...,
    H, W) f32). The host side of ``rasterize_pallas`` and
    ``rasterize_pallas_batch``; any scene size renders in one pass (the JAX
    package's slot cap and multipass answer the TPU's SMEM, which the card
    does not have). The route follows S alone."""
    _check_sampling(sampling)
    trf, tri = pack_setup_tables(setup)
    kw = dict(width=width, height=height, background=background)
    if trf.shape[-1] <= FLAT_MAX_SLOTS:
        ids, counts = bin_triangles(setup, width=width, height=height,
                                    tile_h=TILE_H, tile_w=TILE_W)
        return _FLAT[sampling](counts, ids, trf, tri, textures, **kw)
    binned = bin_segments(setup, width=width, height=height)
    return _SEGMENTED[sampling](*binned, trf, tri, textures, **kw)
