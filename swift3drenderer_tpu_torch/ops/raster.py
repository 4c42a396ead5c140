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
runs one thread per pixel of a tile, one block per tile and frame (the
segmented kernels) or per up to 16 tiles spread over a frame (the flat ones,
which copy the table columns of the slots those tiles list into shared
memory once): visibility over the tile's lists, then the winner's shading
and texel fetch, all in one launch as on the TPU, for any scene size.

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

Bands. ``y_offset`` is the first framebuffer row of a band of ``height`` rows
(the fb axis of ``parallel.render_batch_sharded``): the setup table stays in
full-frame rows, the binners clip each slot to the band's tiles and drop the
slots outside it, and the kernels cover rows [y_offset, y_offset + height)
into a (height, W) output. ``y_offset=0`` with the frame's own height is the
whole frame.

Winner ids. With ``track_ids=True`` a kernel also writes each pixel's
winner's row ``_GID`` value (``pack_setup_tables``' ``gids``), -1 where
nothing covers: the third output plane of the JAX kernel's ``track_ids`` form,
the key by which passes and devices merge (``rasterize(gids=...)``).

Timing forms. ``phases`` (``PHASES``) is the JAX kernel's timing instrument
(raster_pallas.py:250-258, read by ``tools.perf_probe``): ``"full"`` renders
the frame; ``"vis"`` stops after visibility and writes each pixel's winning
slot (-1 where nothing covers) to the pixel plane and its 1/z to depth;
``"shade"`` stops before the texel fetch: flat-coloured winners hold their
packed colour, textured winners the background. Only ``"full"`` is a frame.
A wrapper counts the launches of these forms in ``.launches_vis`` and
``.launches_shade``, apart from the full forms' ``.launches`` and
``.launches_ids``.
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
# The kernels' forms, in the order of csrc/raster.cu's kFull, kVis, kShade.
PHASES = ("full", "vis", "shade")

# The port's pixel tile: one warp spans one 32-pixel row, so output stores
# coalesce; 1080 and 2160 are multiples of 8, so the common frames have no
# ragged tiles. A thread block draws one tile at a time; csrc/raster.cu
# fixes the same shape (kTileW, kTileH).
TILE_W, TILE_H = 32, 8

# Scenes of at most FLAT_MAX_SLOTS slots take the flat kernels; larger ones
# the segmented front-end and kernels. The same scenes take the same form in
# the JAX package (S + 3 <= 128, raster_pallas.py:1477; its other condition,
# B * ntiles <= 512, answers the TPU's SMEM and does not change winners). The
# flat kernels stage the table columns of up to this many slots in shared
# memory (csrc/raster.cu's kFlatMaxSlots).
FLAT_MAX_SLOTS = 125

# Tiles a slot's bbox may cover before the segmented binner sends it to the
# broadband list instead of giving it one entry per tile. Larger K sorts more
# entries (K * S keys); smaller K sends more slots to the broadband list,
# whose bboxes every tile tests. 16 gave the least device time (sort +
# kernel) summed over stress 840 at 1080p and 4K and stress100k at 1080p
# (chip_smoke.py's K sweep; PERF.md).
SEG_K = 16

# The super-tile of the segmented binner: G x G tiles (256 x 64 px at G = 8).
# A live slot covering more than SEG_K tiles but at most SEG_K super-tiles
# gets one entry per super-tile it covers; a tile walks its super-tile's
# segment with a bbox test. Only wider slots stay on the frame-wide
# broadband list, which every tile walks.
SEG_G = 8

# One launch's limits. The grid's third axis holds at most 65,535 frames
# (csrc/raster.cu refuses more); the kernels index a batch's tables, and
# bin_segments keys a batch's entries, with 32-bit offsets. ``rasterize``
# splits a batch into launches within all three.
LAUNCH_MAX_FRAMES = 65_535
TABLE_MAX_WORDS = 2 ** 31 - 1      # words of a batch's (B, 43, S) table
SORT_MAX_KEYS = 2 ** 31 - 1        # B * (tiles + super-tiles + 1) sort keys

# Words of a slot record (``pack_slot_records``): the 12 f32 visibility rows
# and the 4 bbox rows, 64 bytes.
REC_WORDS = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def seg_lists(width: int, height: int, g: int = SEG_G) -> Tuple[int, int]:
    """(tiles, super-tiles) of a width x height frame or band: the
    segmented binner's lists per frame, tiles first."""
    ntx, nty = _cdiv(width, TILE_W), _cdiv(height, TILE_H)
    return ntx * nty, _cdiv(ntx, g) * _cdiv(nty, g)


def pack_setup_tables(setup: Dict[str, torch.Tensor], gids=None):
    """Pack the setup table into (row, slot) arrays: (..., 43, S) f32 and
    (..., 7, S) i32. Row _GID holds each slot's global setup index: ``gids``
    ((S,) or (..., S) int32), or the slot's own index by default (one pass
    covers the whole table)."""
    live = setup["live"]
    n = live.shape[-1]
    if gids is None:
        gids = torch.arange(n, dtype=torch.int32, device=live.device)

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
        torch.as_tensor(gids, dtype=torch.int32,
                        device=live.device).expand(live.shape),
    ], dim=-2).to(torch.int32).contiguous()               # (..., 7, S)
    return f32, i32


def pack_slot_records(setup: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The segmented kernels' visibility records, slot-major: (..., S, 16)
    f32, per slot the table rows that visibility reads — w00, dx, dy and rvz
    (``pack_setup_tables``' f32 rows 0-11) and xmin, xmax, ymin, ymax (its
    i32 rows 0-3, bit-cast) — 64 bytes a slot, so a kernel stages a slot's
    record with four 16-byte copies. One concatenation: the int32 rows go in
    as float32 views."""
    bbox = [setup[r][..., None].view(torch.float32)
            for r in ("xmin", "xmax", "ymin", "ymax")]
    return torch.cat([setup["w00"], setup["dx"], setup["dy"], setup["rvz"],
                      *bbox], dim=-1)


def _tile_bbox(setup: Dict[str, torch.Tensor], ntx: int, nty: int,
               tile_w: int, tile_h: int, y_offset: int = 0):
    """Each slot's bbox in the tile coordinates of the band that starts at
    row ``y_offset``, clamped to its grid: (txmin, txmax, tymin, tymax),
    (..., S) int32 each."""
    def tiles(v, size, n):
        return torch.clamp(torch.div(v, size, rounding_mode="floor"), 0, n - 1)

    def rows(v):
        return v - y_offset if y_offset else v

    return (tiles(setup["xmin"], tile_w, ntx), tiles(setup["xmax"], tile_w, ntx),
            tiles(rows(setup["ymin"]), tile_h, nty),
            tiles(rows(setup["ymax"]), tile_h, nty))


def _live_in_band(setup: Dict[str, torch.Tensor], height: int,
                  y_offset: int) -> torch.Tensor:
    """The live slots whose bbox meets rows [y_offset, y_offset + height): a
    live slot's bbox is clamped to the whole frame, not to a band. It ends
    at a row >= 0, so a band at row 0 needs no test above it."""
    live = setup["live"] & (setup["ymin"] < y_offset + height)
    return live & (setup["ymax"] >= y_offset) if y_offset else live


def _check_band(y_offset: int) -> None:
    if y_offset < 0:
        raise ValueError(f"y_offset={y_offset}: a band starts at a row >= 0")


def bin_triangles(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                  tile_h: int, tile_w: int, y_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map each live triangle to the tiles of the band [y_offset, y_offset +
    height) that its bbox touches.

    Returns (ids (..., ntiles, S) int32 — touching triangle slots first,
    ascending; counts (..., ntiles, 1) int32). Ascending id order preserves
    the reference's earlier-triangle-wins depth ties.
    """
    live = _live_in_band(setup, height, y_offset)
    dev = live.device
    ntx, nty = _cdiv(width, tile_w), _cdiv(height, tile_h)
    txmin, txmax, tymin, tymax = _tile_bbox(setup, ntx, nty, tile_w, tile_h,
                                            y_offset)
    tx = torch.arange(ntx, dtype=torch.int32, device=dev)
    ty = torch.arange(nty, dtype=torch.int32, device=dev)
    touch_x = (tx >= txmin[..., None]) & (tx <= txmax[..., None])
    touch_y = ((ty >= tymin[..., None]) & (ty <= tymax[..., None])
               & live[..., None])
    touch = touch_y[..., :, None] & touch_x[..., None, :]
    touch = touch.flatten(-2).transpose(-1, -2)             # (..., ntiles, S)
    s = touch.shape[-1]
    # Stable partition (touching slots first, both groups ascending) as a
    # sort of one unique key: untouched slots get their index + S.
    slot = torch.arange(s, dtype=torch.int32, device=dev)
    keys = torch.where(touch, slot, slot + s)
    ids = (torch.sort(keys, dim=-1).values % s).to(torch.int32).contiguous()
    counts = touch.sum(dim=-1, dtype=torch.int32)[..., None].contiguous()
    return ids, counts


@functools.cache
def _level_consts(device: torch.device, width: int, height: int, g: int,
                  y_offset: int):
    """Constants of ``segment_keys``' two levels (0: tiles, 1: super-tiles),
    made once per device and grid: each bbox row's divisor and last index
    (2, 4) for the rows (xmin, xmax, ymin, ymax); each level's key stride
    and first key (2,); the band's row offset (4,). Never evicted: a CUDA
    graph captured with them reads them by address at every replay."""
    ntx, nty = _cdiv(width, TILE_W), _cdiv(height, TILE_H)
    nsx, nsy = _cdiv(ntx, g), _cdiv(nty, g)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return (ints([[TILE_W, TILE_W, TILE_H, TILE_H],
                  [TILE_W * g, TILE_W * g, TILE_H * g, TILE_H * g]]),
            ints([[ntx - 1, ntx - 1, nty - 1, nty - 1],
                  [nsx - 1, nsx - 1, nsy - 1, nsy - 1]]),
            ints([ntx, nsx]), ints([0, ntx * nty]),
            ints([0, 0, y_offset, y_offset]))


def segment_keys(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                 k: int = SEG_K, g: int = SEG_G, y_offset: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unsorted entries of ``bin_segments``: (keys (..., S*K) int32, big
    (..., S) bool). Entry ``slot * K + e`` of a live slot whose bbox covers
    at most K tiles is the e-th of those tiles, row-major, keyed by the
    tile's index; of a live slot covering more tiles but at most K
    super-tiles (G x G tiles), the e-th of those super-tiles, keyed
    ``ntiles + supertile``. Every other entry is keyed ``ntiles + nsuper``,
    past every list. ``big`` marks the live slots covering more than K
    super-tiles: the residual broadband list. A key is at most ``ntiles +
    nsuper``, bounded by the grid alone, whatever S. The tiles are those of
    the band [y_offset, y_offset + height); live slots outside it count as
    dead, and its super-tiles cover its tiles from its first row.

    Both levels are computed at once on a leading level axis, so a frame
    launches about as many kernels as with tiles alone."""
    ntiles, nsuper = seg_lists(width, height, g)
    live = _live_in_band(setup, height, y_offset)
    div, last, stride, first, band = _level_consts(live.device, width, height,
                                                   g, y_offset)
    ones = (1,) * live.dim()
    box = torch.stack([setup["xmin"], setup["xmax"], setup["ymin"],
                       setup["ymax"]])                     # (4, ..., S)
    if y_offset:
        box = box - band.view(4, *ones)
    # (x0, x1, y0, y1) in tiles and in super-tiles, clamped to the band's
    # grid: (2, 4, ..., S). floor(v / (TILE * g)) clamped equals the clamped
    # tile index divided by g.
    lv = torch.minimum(torch.div(box, div.view(2, 4, *ones),
                                 rounding_mode="floor").clamp_(min=0),
                       last.view(2, 4, *ones))
    # (wx, wy) per level. Dead slots may have an empty bbox; clamping keeps
    # the division below defined.
    ext = (lv[:, 1::2] - lv[:, ::2] + 1).clamp_(min=1)
    area = ext[:, 0] * ext[:, 1]
    # Per level: the key of the bbox's first cell, its row width, and the
    # step from a row's end to the next row's start.
    origin = (torch.addcmul(lv[:, 0], lv[:, 2], stride.view(2, *ones))
              + first.view(2, *ones))
    skip = stride.view(2, *ones) - ext[:, 0]
    per_level = torch.stack([origin, ext[:, 0], area, skip])   # (4, 2, ..., S)
    origin, wx, area_k, skip = torch.where(area[0] <= k, per_level[:, 0],
                                           per_level[:, 1])
    listed = live & (area[1] <= k)
    e = torch.arange(k, dtype=torch.int32, device=live.device)
    dy = torch.div(e, wx[..., None], rounding_mode="floor")
    key = torch.addcmul(origin[..., None] + e, dy, skip[..., None])
    keys = torch.where(listed[..., None] & (e < area_k[..., None]), key,
                       ntiles + nsuper)
    return keys.flatten(-2).to(torch.int32), live ^ listed


def bin_segments(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                 k: int = SEG_K, g: int = SEG_G, y_offset: int = 0):
    """Segmented binning at TILE_W x TILE_H over the band [y_offset, y_offset
    + height): the large-scene front-end (``raster_pallas.py::bin_segments``).

    Each live slot whose bbox covers at most K tiles gives one (tile, slot)
    entry per covered tile; a slot covering more tiles but at most K
    super-tiles of G x G tiles gives one (super-tile, slot) entry per covered
    super-tile. One stable sort of the list keys (``segment_keys``),
    slot-major, groups the entries by list — the tiles' first, then the
    super-tiles' — with ascending slots within each list. Slots covering
    more super-tiles go to one shared ascending residual broadband list. A
    tile's kernel block walks its own segment, its super-tile's segment and
    the residual list, the last two tested against the tile's bbox. Every
    shape is static (K*S entries per frame) and nothing is read back to the
    host, so a frame makes no device-to-host copy. A batch sorts once: frame
    b's keys are offset by b * (ntiles + nsuper + 1), so its entries keep
    their order and land in its own K*S positions.

    Returns (ids (..., K*S) int32: entry slots, list-major, the tail past the
    last segment unused; starts (..., ntiles + nsuper) int32 and counts
    (..., ntiles + nsuper) int32: each tile's, then each super-tile's,
    segment of its frame's ``ids``; bb (..., S) int32: the residual
    broadband slots ascending, then the other slots; bb_count (..., 1)
    int32: the residual list's length; bb_box (..., S, 4) int32: the bbox
    (xmin, xmax, ymin, ymax) of each slot of ``bb``, in its order, which the
    kernels' residual filter reads without waiting for the slot id). The
    segmented kernels also take the slot records of ``pack_slot_records``.
    """
    keys, big = segment_keys(setup, width=width, height=height, k=k, g=g,
                             y_offset=y_offset)
    dev = keys.device
    lead, s = big.shape[:-1], big.shape[-1]
    keys = keys.reshape(-1, s * k)
    nlists = sum(seg_lists(width, height, g))
    if keys.shape[0] * (nlists + 1) > SORT_MAX_KEYS:
        raise ValueError(f"{keys.shape[0]} frames of {nlists + 1} sort keys: "
                         f"past {SORT_MAX_KEYS}; bin fewer frames at once")
    frame = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)[:, None]
    sorted_keys, order = torch.sort((keys + frame * (nlists + 1)).reshape(-1),
                                    stable=True)
    ids = (torch.div(order, k, rounding_mode="floor") % s).to(torch.int32)
    targets = frame * (nlists + 1) + torch.arange(nlists + 1, dtype=torch.int32,
                                                  device=dev)
    bounds = torch.searchsorted(sorted_keys, targets.reshape(-1),
                                out_int32=True).reshape(-1, nlists + 1)
    starts = bounds[:, :-1] - frame * (s * k)
    counts = bounds[:, 1:] - bounds[:, :-1]
    bb = torch.sort(big, dim=-1, descending=True, stable=True).indices
    box = torch.stack([setup[r] for r in ("xmin", "xmax", "ymin", "ymax")],
                      dim=-1).to(torch.int32)
    return (ids.reshape(*lead, s * k), starts.reshape(*lead, nlists).contiguous(),
            counts.reshape(*lead, nlists).contiguous(), bb.to(torch.int32),
            big.sum(dim=-1, dtype=torch.int32)[..., None],
            torch.take_along_dim(box, bb[..., None], dim=-2))


# ---------------------------------------------------------------------------
# The plain PyTorch versions of the flat kernels.

def _binned_slots(counts: torch.Tensor, ids: torch.Tensor) -> list:
    """Ascending list of every slot some tile's list holds (one frame)."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return torch.unique(ids[pos < counts]).tolist()


def tile_cull_plain(counts: torch.Tensor, ids: torch.Tensor,
                    trf: torch.Tensor, tri: torch.Tensor, *, width: int,
                    height: int, y_offset: int = 0) -> torch.Tensor:
    """The flat kernels' per-tile cull (csrc/raster.cu::tile_may_cover) over
    one frame's lists: (ntiles, S) bool, True where entry j of a tile's list
    (``ids`` order) is listed and survives: its bbox meets the tile and none
    of its edge functions, rounded as the visit rounds them, is negative at
    the tile corner its signs pick (the largest value it takes over the
    tile; a NaN survives). A culled slot covers no pixel of its tile, so the
    plain versions need no cull; this is for tests and measurements."""
    dev = trf.device
    ntx = _cdiv(width, TILE_W)
    t = torch.arange(counts.shape[0], device=dev)[:, None]
    s = ids.long()
    x0, y0 = t % ntx * TILE_W, t // ntx * TILE_H + y_offset
    x1, y1 = x0 + TILE_W - 1, y0 + TILE_H - 1
    listed = torch.arange(ids.shape[1], device=dev)[None, :] < counts
    keep = (listed & (tri[_XMIN][s] <= x1) & (tri[_XMAX][s] >= x0)
            & (tri[_YMIN][s] <= y1) & (tri[_YMAX][s] >= y0))
    for k in range(3):
        w00, dx, dy = (trf[r + k][s] for r in (_W00, _DX, _DY))
        keep &= ~((w00 + torch.where(dx >= 0, x1, x0).to(torch.float32) * dx)
                  + torch.where(dy >= 0, y1, y0).to(torch.float32) * dy < 0)
    return keep


def _check_gid_order(tri: torch.Tensor, slots: torch.Tensor) -> None:
    """The tracking forms' precondition, on one frame's binned slots
    (ascending): their row-_GID values ascend too. The kernels keep the
    smaller slot at a depth tie; the JAX segmented kernel keeps the smaller
    gid; the two agree exactly when gids ascend with slot order, as every
    caller's do (2 * (base + triangle) + {0, 1}). Checked here, where a
    scalar read is allowed; the card's wrappers do not read back."""
    g = tri[_GID][slots]
    if g.numel() > 1 and not bool((g[1:] > g[:-1]).all()):
        raise ValueError("gids must ascend with slot order among a frame's "
                         "live slots")


def _gid_plane(win: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Each pixel's winner's row-_GID value, -1 where nothing covers."""
    return torch.where(win >= 0, tri[_GID][win.clamp(min=0).long()], -1)


def visibility_plain(counts: torch.Tensor, ids: torch.Tensor,
                     trf: torch.Tensor, tri: torch.Tensor, *, width: int,
                     height: int, y_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of one frame over the whole band: (best 1/z (H, W) f32,
    winner slot (H, W) i32, -1 where nothing covers). Slots are walked in
    ascending order with the strict ``>`` update, so the earlier slot keeps a
    depth tie (render.swift:323-325)."""
    dev = trf.device
    pyi = y_offset + torch.arange(height, dtype=torch.int32, device=dev)[:, None]
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
    """1 / sqrt(x*x + y*y + z*z) with the square root correctly rounded, as
    the kernels' sqrtf and XLA round it. torch.sqrt on the CPU is not on
    every build (an AVX-512 build of torch 2.13 is 1 ulp low on some of a
    stress frame's normalisations); a float64 square root rounded to
    float32 is correctly rounded for every float32 input."""
    return 1.0 / torch.sqrt((x * x + y * y + z * z).double()).float()


def _shade_winners(best: torch.Tensor, win: torch.Tensor, trf: torch.Tensor,
                   tri: torch.Tensor, y_offset: int = 0):
    """Phase 2 for every pixel of one frame (or band) that has a winner:
    perspective-correct weights, halfway-vector headlight and the flat color
    pack. Returns (pixel rows, pixel columns, shade, packs, textured mask)
    over those pixels, and the inputs of phase 3's texel fetch over the
    textured ones: (texture index, uv (n, 2), ripmap level (n, 2))."""
    yy, xx = torch.nonzero(win >= 0, as_tuple=True)
    s = win[yy, xx].long()
    pxf, pyf = xx.to(torch.float32), (yy + y_offset).to(torch.float32)
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
                sampling: str = "nearest", y_offset: int = 0,
                fetch: bool = True) -> torch.Tensor:
    """Phases 2 and 3 for every pixel of one frame (or of the band that
    starts at row ``y_offset``) that has a winner: the flat color pack, or
    the nearest or bilinear texel fetch and shade multiply. Background
    elsewhere. Returns packed pixels (H, W) int32. ``fetch=False`` stops
    before phase 3, as the ``"shade"`` form does: textured winners hold the
    background."""
    _check_sampling(sampling)
    pix = torch.full(best.shape, background, dtype=torch.int32,
                     device=best.device)
    yy, xx, sh, out, tx, tex, uv, level = _shade_winners(best, win, trf, tri,
                                                         y_offset)
    if not fetch:
        out[tx] = background
    elif bool(tx.any()):
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


def _check_phases(phases: str) -> None:
    if phases not in PHASES:
        raise ValueError(f"phases={phases!r}: the kernels' forms are "
                         f"{', '.join(PHASES)}")


def _plain_outputs(best, win, trf, tri, textures, *, background, sampling,
                   y_offset, track_ids, phases):
    """Phases 2-3 of one frame from its phase 1: (pixels, depth[, gids]);
    the ``"vis"`` form's pixels are the winning slots."""
    if phases == "vis":
        pix = win
    else:
        pix = shade_plain(best, win, trf, tri, textures, background=background,
                          sampling=sampling, y_offset=y_offset,
                          fetch=phases == "full")
    return (pix, best, _gid_plane(win, tri)) if track_ids else (pix, best)


def raster_flat_plain(counts, ids, trf, tri, textures, *, width: int,
                      height: int, background: int, sampling: str,
                      y_offset: int = 0, track_ids: bool = False,
                      phases: str = "full"):
    """Plain PyTorch version of the flat kernels: same inputs, same (pixels
    (..., H, W) int32, depth (..., H, W) f32[, gids (..., H, W) int32]),
    over rows [y_offset, y_offset + H), in the form ``phases``."""
    _check_band(y_offset)
    _check_phases(phases)

    def frame(c, i, f, t):
        if track_ids:
            _check_gid_order(t, torch.tensor(_binned_slots(c, i), dtype=torch.long))
        best, win = visibility_plain(c, i, f, t, width=width, height=height,
                                     y_offset=y_offset)
        return _plain_outputs(best, win, f, t, textures, background=background,
                              sampling=sampling, y_offset=y_offset,
                              track_ids=track_ids, phases=phases)

    return _over_frames(frame, (counts, ids, trf, tri), trf)


def raster_flat_nearest_plain(counts, ids, trf, tri, textures, **kw):
    """Plain PyTorch version of ``raster_flat_nearest``."""
    return raster_flat_plain(counts, ids, trf, tri, textures,
                             sampling="nearest", **kw)


def raster_flat_bilinear_plain(counts, ids, trf, tri, textures, **kw):
    """Plain PyTorch version of ``raster_flat_bilinear``."""
    return raster_flat_plain(counts, ids, trf, tri, textures,
                             sampling="bilinear", **kw)


# ---------------------------------------------------------------------------
# The plain PyTorch versions of the segmented kernels.

# (tile, slot) pairs evaluated at once by the plain segmented visibility: each
# pair is one tile's TILE_W x TILE_H pixels.
_PAIR_CHUNK = 8192
_I32_MAX_KEY = (1 << 31) - 1


def segmented_pairs(ids, starts, counts, bb, bb_count, bb_box, tri, *,
                    width: int,
                    height: int, g: int = SEG_G, y_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (tile, slot) pair the segmented kernel evaluates and may let win
    in one frame (or band): each tile's segment; each super-tile segment's
    slot with every tile of that super-tile its bbox touches; each residual
    broadband slot with every tile its bbox touches. Returns (tiles, slots),
    int64 (n,) each. The bboxes come from ``tri``; ``bb_box`` is unread.
    Reads counts back to the host: for the plain version and measurements
    only."""
    dev = ids.device
    ntx, nty = _cdiv(width, TILE_W), _cdiv(height, TILE_H)
    ntiles, nsuper = seg_lists(width, height, g)
    counts = counts.long()
    lists = torch.repeat_interleave(torch.arange(ntiles + nsuper, device=dev),
                                    counts)
    first = torch.cumsum(counts, 0) - counts         # each segment's own start
    pos = (starts.long()[lists] + torch.arange(lists.numel(), device=dev)
           - first[lists])
    slots = ids.long()[pos]
    in_tile = lists < ntiles
    tx0, tx1, ty0, ty1 = (v.long() for v in _tile_bbox(
        {"xmin": tri[_XMIN], "xmax": tri[_XMAX], "ymin": tri[_YMIN],
         "ymax": tri[_YMAX]}, ntx, nty, TILE_W, TILE_H, y_offset))
    # Super-tile entries: the slot's tiles inside the super-tile.
    sup, sup_slots = lists[~in_tile] - ntiles, slots[~in_tile]
    sx0, sy0 = sup % _cdiv(ntx, g) * g, sup // _cdiv(ntx, g) * g
    big = bb[:int(bb_count.reshape(-1)[0])].long()
    wide = torch.cat([sup_slots, big])
    x0 = torch.cat([torch.maximum(tx0[sup_slots], sx0), tx0[big]])
    x1 = torch.cat([torch.minimum(tx1[sup_slots], sx0 + g - 1), tx1[big]])
    y0 = torch.cat([torch.maximum(ty0[sup_slots], sy0), ty0[big]])
    y1 = torch.cat([torch.minimum(ty1[sup_slots], sy0 + g - 1), ty1[big]])
    wx = (x1 - x0 + 1).clamp(min=0)
    area = wx * (y1 - y0 + 1).clamp(min=0)
    wide_slots = torch.repeat_interleave(wide, area)
    j = (torch.arange(wide_slots.numel(), device=dev)
         - torch.repeat_interleave(torch.cumsum(area, 0) - area, area))
    wx, x0, y0 = (torch.repeat_interleave(v, area) for v in (wx, x0, y0))
    wide_tiles = (y0 + j // wx) * ntx + x0 + j % wx
    return (torch.cat([lists[in_tile], wide_tiles]),
            torch.cat([slots[in_tile], wide_slots]))


def visibility_segmented_plain(ids, starts, counts, bb, bb_count, bb_box,
                               trf, tri, *,
                               width: int, height: int, g: int = SEG_G,
                               y_offset: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the segmented kernels over one whole frame (or band): (best
    1/z (H, W) f32, winner slot (H, W) i32, -1 where nothing covers), from
    the (43, S) and (7, S) tables: not from the slot records and residual
    bboxes the kernel reads, so that a comparison with the kernel also
    checks ``pack_slot_records`` and ``bb_box``.

    Every (tile, slot) pair of ``segmented_pairs`` is evaluated over the
    tile's pixels, in chunks, with each edge function rounded as ``(w00 +
    px*dx) + py*dy`` as the kernel rounds it. A pixel's winner is the order-independent rule of
    raster_pallas.py:463-471 — the greatest 1/z, and at equal 1/z > 0 the
    smaller slot — taken by one ``amax`` over the int64 key ``bits(1/z) << 32
    | (2^31 - 1 - slot)``: positive f32 bit patterns order as the floats do,
    and 1/z <= 0 (or NaN) never wins."""
    dev = trf.device
    ntx = _cdiv(width, TILE_W)
    tiles, slots = segmented_pairs(ids, starts, counts, bb, bb_count, bb_box,
                                   tri,
                                   width=width, height=height, g=g,
                                   y_offset=y_offset)
    lane = torch.arange(TILE_W * TILE_H, device=dev)
    lx, ly = lane % TILE_W, lane // TILE_W
    key = torch.zeros(height * width, dtype=torch.int64, device=dev)
    for c in range(0, tiles.numel(), _PAIR_CHUNK):
        t, s = tiles[c:c + _PAIR_CHUNK], slots[c:c + _PAIR_CHUNK]
        px = (t % ntx * TILE_W)[:, None] + lx[None, :]
        row = (t // ntx * TILE_H)[:, None] + ly[None, :]
        py = row + y_offset
        pxf, pyf = px.to(torch.float32), py.to(torch.float32)
        f, i = trf[:, s, None], tri[:, s, None]
        w0, w1, w2 = (f[_W00 + k] + pxf * f[_DX + k] + pyf * f[_DY + k]
                      for k in range(3))
        ooz = w0 * f[_RVZ] + w1 * f[_RVZ + 1] + w2 * f[_RVZ + 2]
        wins = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (ooz > 0)
                & (px >= i[_XMIN]) & (px <= i[_XMAX])
                & (py >= i[_YMIN]) & (py <= i[_YMAX])
                & (px < width) & (row < height))
        k = ((ooz.view(torch.int32).to(torch.int64) << 32)
             | (_I32_MAX_KEY - s)[:, None])
        key.scatter_reduce_(0, torch.where(wins, row * width + px, 0).reshape(-1),
                            torch.where(wins, k, 0).reshape(-1), reduce="amax")
    best = (key >> 32).to(torch.int32).view(torch.float32).reshape(height, width)
    win = torch.where(key > 0, _I32_MAX_KEY - (key & _I32_MAX_KEY), -1)
    return best, win.to(torch.int32).reshape(height, width)


def raster_segmented_plain(ids, starts, counts, bb, bb_count, bb_box, trf,
                           tri, rec, textures, *, width: int, height: int,
                           background: int, sampling: str, g: int = SEG_G,
                           y_offset: int = 0, track_ids: bool = False,
                           phases: str = "full"):
    """Plain PyTorch version of the segmented kernels: same inputs, same
    (pixels (..., H, W) int32, depth (..., H, W) f32[, gids (..., H, W)
    int32]), over rows [y_offset, y_offset + H), in the form ``phases``.
    ``bb_box`` and ``rec`` are checked for their shapes and otherwise unread:
    the plain version reads the tables."""
    _check_band(y_offset)
    _check_phases(phases)
    lead, s = tuple(trf.shape[:-2]), trf.shape[-1]
    for name, t, words in (("bb_box", bb_box, 4), ("rec", rec, REC_WORDS)):
        if tuple(t.shape) != (*lead, s, words):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                             f"{(*lead, s, words)}")

    def frame(i, st, c, b, n, f, t):
        if track_ids:     # the segments lie at the head of ids, list-major
            _check_gid_order(t, torch.unique(torch.cat(
                [i[:int(c.sum())], b[:int(n.reshape(-1)[0])]]).long()))
        best, win = visibility_segmented_plain(i, st, c, b, n, None, f, t,
                                               width=width, height=height,
                                               g=g, y_offset=y_offset)
        return _plain_outputs(best, win, f, t, textures, background=background,
                              sampling=sampling, y_offset=y_offset,
                              track_ids=track_ids, phases=phases)

    return _over_frames(frame, (ids, starts, counts, bb, bb_count, trf, tri),
                        trf)


def raster_segmented_nearest_plain(ids, starts, counts, bb, bb_count, bb_box,
                                   trf, tri, rec, textures, **kw):
    """Plain PyTorch version of ``raster_segmented_nearest``."""
    return raster_segmented_plain(ids, starts, counts, bb, bb_count, bb_box,
                                  trf, tri, rec, textures, sampling="nearest",
                                  **kw)


def raster_segmented_bilinear_plain(ids, starts, counts, bb, bb_count, bb_box,
                                    trf, tri, rec, textures, **kw):
    """Plain PyTorch version of ``raster_segmented_bilinear``."""
    return raster_segmented_plain(ids, starts, counts, bb, bb_count, bb_box,
                                  trf, tri, rec, textures, sampling="bilinear",
                                  **kw)


# ---------------------------------------------------------------------------
# The kernels' wrappers.

@functools.cache
def _kernel(name: str, pointers: int, ints: int):
    """The C entry point ``name``: ``pointers`` device pointers (the last,
    the gid plane, may be null), then ``ints`` ints (B, S, [entries per
    frame, the super-tile edge G,] the texture count, width, height, y0,
    background and the form, ``PHASES.index(phases)``), then the stream."""
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
    if trf.numel() > TABLE_MAX_WORDS:
        raise ValueError(f"trf: {trf.numel()} words, past one launch's "
                         f"{TABLE_MAX_WORDS}; render the batch in smaller "
                         "batches (rasterize splits it)")
    if trf.dim() == 3 and trf.shape[0] > LAUNCH_MAX_FRAMES:
        raise ValueError(f"{trf.shape[0]} frames, past one launch's "
                         f"{LAUNCH_MAX_FRAMES} (rasterize splits the batch)")
    return tuple(trf.shape[:-2]), trf.shape[-1]


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(wrapper, inputs, textures: torch.Tensor, lead, ints, *,
            width: int, height: int, background: int, y_offset: int,
            track_ids: bool, phases: str):
    """Allocate the (..., H, W) outputs and launch ``wrapper``'s kernel on
    the tensors' card over the frames' tiles, in its tracking form when
    ``track_ids`` (a gid plane is passed) or not (a null pointer) and in the
    form ``phases``; raise if the launch was refused, else count it: a full
    form in ``.launches`` or ``.launches_ids``, a timing form in
    ``.launches_vis`` or ``.launches_shade``. Under CUDA graph capture the
    launch goes into the graph and counts once; replays are not counted."""
    dev = textures.device
    outs = [torch.empty((*lead, height, width), dtype=dt, device=dev)
            for dt in (torch.int32, torch.float32, torch.int32)[:2 + track_ids]]
    ptrs = [t.data_ptr() for t in (*inputs, textures, *outs)]
    ptrs += [] if track_ids else [None]
    ints = (math.prod(lead), *ints, textures.shape[0], width, height, y_offset,
            background, PHASES.index(phases))
    name = wrapper.__name__
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _kernel(name, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {kernels.error_string(err)}")
    if phases != "full":
        setattr(wrapper, f"launches_{phases}",
                getattr(wrapper, f"launches_{phases}") + 1)
    elif track_ids:
        wrapper.launches_ids += 1
    else:
        wrapper.launches += 1
    return tuple(outs)


def _raster_flat(wrapper, sampling, counts, ids, trf, tri, textures, *,
                 width, height, background, y_offset, track_ids, phases):
    kw = dict(width=width, height=height, background=background,
              y_offset=y_offset, track_ids=track_ids, phases=phases)
    dev = trf.device
    if dev.type == "cpu":
        return raster_flat_plain(counts, ids, trf, tri, textures,
                                 sampling=sampling, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {dev}")
    _check_band(y_offset)
    _check_phases(phases)
    lead, s = _frame_dims(trf)
    if s > FLAT_MAX_SLOTS:
        raise ValueError(f"{wrapper.__name__}: {s} slots, past the flat "
                         f"kernels' {FLAT_MAX_SLOTS} (a frame's rows stay in "
                         "shared memory); bin_segments and the segmented "
                         "kernels take any S")
    ntiles = _cdiv(width, TILE_W) * _cdiv(height, TILE_H)
    _check(counts, "counts", torch.int32, (*lead, ntiles, 1), dev)
    _check(ids, "ids", torch.int32, (*lead, ntiles, s), dev)
    _check(trf, "trf", torch.float32, (*lead, _F32_ROWS, s), dev)
    _check(tri, "tri", torch.int32, (*lead, _I32_ROWS, s), dev)
    _check(textures, "textures", torch.int32,
           (textures.shape[0], 512, 512), dev)
    return _launch(wrapper, (counts, ids, trf, tri), textures, lead, (s,), **kw)


def raster_flat_nearest(counts: torch.Tensor, ids: torch.Tensor,
                        trf: torch.Tensor, tri: torch.Tensor,
                        textures: torch.Tensor, *, width: int, height: int,
                        background: int, y_offset: int = 0,
                        track_ids: bool = False, phases: str = "full"):
    """Visibility, deferred shading and nearest texel fetch for one frame or
    a batch, in one launch.

    counts (..., ntiles, 1) i32 and ids (..., ntiles, S) i32 from
    ``bin_triangles`` at TILE_W x TILE_H (with the same ``y_offset``); trf
    (..., 43, S) f32 and tri (..., 7, S) i32 from ``pack_setup_tables``,
    at most FLAT_MAX_SLOTS slots on the card;
    textures (NT, 512, 512) i32, shared by every frame. The leading axis,
    where present, is the batch B. Returns (pixels (..., H, W) int32 holding
    0x00RRGGBB, depth (..., H, W) f32 = 1/z, 0 where empty) for framebuffer
    rows [y_offset, y_offset + H); with ``track_ids`` also the winners' row
    _GID values (..., H, W) int32, -1 where empty, whose precondition
    (``_check_gid_order``: gids ascend with slot order among live slots) the
    plain version checks. ``phases`` picks the form (``PHASES``): the timing
    forms ``"vis"`` and ``"shade"`` stop early (the module's docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``raster_flat_nearest.launches`` counts the kernel's launches, and
    ``.launches_ids`` those of its tracking form: each call that launches,
    eagerly or into a CUDA graph being captured (counted once, at capture;
    the graph's replays launch without the wrapper, and
    ``graphs.FrameGraphs.replays`` counts those); ``.launches_vis`` and
    ``.launches_shade`` those of the timing forms.
    """
    return _raster_flat(raster_flat_nearest, "nearest", counts, ids, trf, tri,
                        textures, width=width, height=height,
                        background=background, y_offset=y_offset,
                        track_ids=track_ids, phases=phases)


def raster_flat_bilinear(counts: torch.Tensor, ids: torch.Tensor,
                         trf: torch.Tensor, tri: torch.Tensor,
                         textures: torch.Tensor, *, width: int, height: int,
                         background: int, y_offset: int = 0,
                         track_ids: bool = False, phases: str = "full"):
    """``raster_flat_nearest`` with the bilinear texel fetch: the four taps
    of ``ops.texture.bilinear_taps``, blended as float channels before the
    shade multiply. ``raster_flat_bilinear.launches``, ``.launches_ids``,
    ``.launches_vis`` and ``.launches_shade`` count its launches, a captured
    one once, at capture."""
    return _raster_flat(raster_flat_bilinear, "bilinear", counts, ids, trf,
                        tri, textures, width=width, height=height,
                        background=background, y_offset=y_offset,
                        track_ids=track_ids, phases=phases)


def _raster_segmented(wrapper, sampling, ids, starts, counts, bb, bb_count,
                      bb_box, trf, tri, rec, textures, *, width, height,
                      background, g, y_offset, track_ids, phases):
    kw = dict(width=width, height=height, background=background,
              y_offset=y_offset, track_ids=track_ids, phases=phases)
    dev = trf.device
    if dev.type == "cpu":
        return raster_segmented_plain(ids, starts, counts, bb, bb_count, bb_box,
                                      trf, tri, rec, textures,
                                      sampling=sampling, g=g, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {dev}")
    _check_band(y_offset)
    _check_phases(phases)
    if g < 1:
        raise ValueError(f"g={g}: a super-tile holds at least one tile")
    lead, s = _frame_dims(trf)
    nlists = sum(seg_lists(width, height, g))
    entries = ids.shape[-1]
    _check(ids, "ids", torch.int32, (*lead, entries), dev)
    _check(starts, "starts", torch.int32, (*lead, nlists), dev)
    _check(counts, "counts", torch.int32, (*lead, nlists), dev)
    _check(bb, "bb", torch.int32, (*lead, s), dev)
    _check(bb_count, "bb_count", torch.int32, (*lead, 1), dev)
    _check(bb_box, "bb_box", torch.int32, (*lead, s, 4), dev)
    _check(trf, "trf", torch.float32, (*lead, _F32_ROWS, s), dev)
    _check(tri, "tri", torch.int32, (*lead, _I32_ROWS, s), dev)
    _check(rec, "rec", torch.float32, (*lead, s, REC_WORDS), dev)
    for name, t in (("bb_box", bb_box), ("rec", rec)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels read it 16 bytes at a "
                             "time; need a 16-byte aligned tensor")
    _check(textures, "textures", torch.int32,
           (textures.shape[0], 512, 512), dev)
    return _launch(wrapper, (ids, starts, counts, bb, bb_count, bb_box, trf,
                             tri, rec), textures, lead, (s, entries, g), **kw)


def raster_segmented_nearest(ids: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, bb: torch.Tensor,
                             bb_count: torch.Tensor, bb_box: torch.Tensor,
                             trf: torch.Tensor, tri: torch.Tensor,
                             rec: torch.Tensor, textures: torch.Tensor, *,
                             width: int, height: int, background: int,
                             g: int = SEG_G, y_offset: int = 0,
                             track_ids: bool = False, phases: str = "full"):
    """Visibility over each tile's segment, its super-tile's segment and the
    residual broadband list, deferred shading and nearest texel fetch for
    one frame or a batch, in one launch.

    ids (..., E) i32, starts (..., ntiles + nsuper) i32, counts (..., ntiles
    + nsuper) i32, bb (..., S) i32, bb_count (..., 1) i32 and bb_box (...,
    S, 4) i32 from ``bin_segments`` (with the same ``g`` and ``y_offset``);
    trf (..., 43, S) f32 and tri (..., 7, S) i32 from
    ``pack_setup_tables``; rec (..., S, 16) f32 from ``pack_slot_records``;
    bb_box and rec 16-byte aligned; textures (NT, 512, 512) i32, shared by
    every frame. The leading axis, where present, is the batch B. Returns
    (pixels (..., H, W) int32 holding 0x00RRGGBB, depth (..., H, W) f32 =
    1/z, 0 where empty[, gids (..., H, W) int32 with ``track_ids``]), equal
    to ``raster_flat_nearest`` on the same setup table, in each form
    ``phases``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``raster_segmented_nearest.launches`` counts the kernel's launches,
    ``.launches_ids`` those of its tracking form and ``.launches_vis`` and
    ``.launches_shade`` those of the timing forms, a captured one once, at
    capture (a graph's replays are not counted here).
    """
    return _raster_segmented(raster_segmented_nearest, "nearest", ids, starts,
                             counts, bb, bb_count, bb_box, trf, tri, rec,
                             textures, width=width, height=height,
                             background=background, g=g, y_offset=y_offset,
                             track_ids=track_ids, phases=phases)


def raster_segmented_bilinear(ids: torch.Tensor, starts: torch.Tensor,
                              counts: torch.Tensor, bb: torch.Tensor,
                              bb_count: torch.Tensor, bb_box: torch.Tensor,
                              trf: torch.Tensor, tri: torch.Tensor,
                              rec: torch.Tensor, textures: torch.Tensor, *,
                              width: int, height: int, background: int,
                              g: int = SEG_G, y_offset: int = 0,
                              track_ids: bool = False, phases: str = "full"):
    """``raster_segmented_nearest`` with the bilinear texel fetch, equal to
    ``raster_flat_bilinear`` on the same setup table.
    ``raster_segmented_bilinear.launches``, ``.launches_ids``,
    ``.launches_vis`` and ``.launches_shade`` count its launches, a captured
    one once, at capture."""
    return _raster_segmented(raster_segmented_bilinear, "bilinear", ids, starts,
                             counts, bb, bb_count, bb_box, trf, tri, rec,
                             textures, width=width, height=height,
                             background=background, g=g, y_offset=y_offset,
                             track_ids=track_ids, phases=phases)


for _wrapper in (raster_flat_nearest, raster_flat_bilinear,
                 raster_segmented_nearest, raster_segmented_bilinear):
    _wrapper.launches = 0
    _wrapper.launches_ids = 0
    _wrapper.launches_vis = 0
    _wrapper.launches_shade = 0

_FLAT = {"nearest": raster_flat_nearest, "bilinear": raster_flat_bilinear}
_SEGMENTED = {"nearest": raster_segmented_nearest,
              "bilinear": raster_segmented_bilinear}

# The gid plane's value where a pixel has no winner after ``rasterize``: the
# identity of the (max 1/z, then min gid) merge (the kernels write -1).
NO_GID = 2 ** 30


def _frames_per_launch(s: int, width: int, height: int) -> int:
    """The most frames of S slots one launch takes: within the grid's frame
    axis (LAUNCH_MAX_FRAMES), the table's 32-bit offsets (TABLE_MAX_WORDS)
    and, on the segmented route, bin_segments' 32-bit sort keys
    (SORT_MAX_KEYS). At least 1: a frame past a limit alone is refused by
    the launch."""
    per = min(LAUNCH_MAX_FRAMES, TABLE_MAX_WORDS // (_F32_ROWS * s))
    if s > FLAT_MAX_SLOTS:
        per = min(per, SORT_MAX_KEYS // (sum(seg_lists(width, height)) + 1))
    return max(per, 1)


def rasterize(setup: Dict[str, torch.Tensor], textures: torch.Tensor, *,
              width: int, height: int, background: int,
              sampling: str = "nearest", gids=None, y_offset: int = 0,
              phases: str = "full"):
    """Bin, pack and rasterize one frame, or a batch (setup arrays with a
    leading B), in one kernel launch: (pixels (..., H, W) int32, depth (...,
    H, W) f32) for framebuffer rows [y_offset, y_offset + H). The host side
    of ``rasterize_pallas`` and ``rasterize_pallas_batch``; any scene size
    renders in one pass (the JAX package's slot cap and multipass answer the
    TPU's SMEM, which the card does not have). The route follows S alone. A
    batch past one launch's limits (``_frames_per_launch``) renders in
    several launches, concatenated.

    With ``gids`` ((S,) or (..., S) int32, ascending with slot order among
    live slots) the launch tracks winners and a third plane holds each
    pixel's winner's gid, NO_GID where depth is 0: the single-pass
    counterpart of ``_rasterize_compacted_ids``. ``phases`` picks the
    kernels' form (``PHASES``; the JAX ``rasterize_pallas(phases=)``): the
    timing forms give the planes the module's docstring describes."""
    _check_sampling(sampling)
    _check_phases(phases)
    live = setup["live"]
    per = _frames_per_launch(live.shape[-1], width, height)
    if live.dim() == 2 and live.shape[0] > per:
        gids = None if gids is None else torch.as_tensor(gids)
        parts = [rasterize(
            {k: v[i:i + per] for k, v in setup.items()}, textures, width=width,
            height=height, background=background, sampling=sampling,
            gids=gids if gids is None or gids.dim() == 1 else gids[i:i + per],
            y_offset=y_offset, phases=phases)
            for i in range(0, live.shape[0], per)]
        return tuple(torch.cat(p) for p in zip(*parts))
    trf, tri = pack_setup_tables(setup, gids)
    track = gids is not None
    kw = dict(width=width, height=height, background=background,
              y_offset=y_offset, track_ids=track, phases=phases)
    if trf.shape[-1] <= FLAT_MAX_SLOTS:
        ids, counts = bin_triangles(setup, width=width, height=height,
                                    tile_h=TILE_H, tile_w=TILE_W,
                                    y_offset=y_offset)
        out = _FLAT[sampling](counts, ids, trf, tri, textures, **kw)
    else:
        binned = bin_segments(setup, width=width, height=height,
                              y_offset=y_offset)
        out = _SEGMENTED[sampling](*binned, trf, tri, pack_slot_records(setup),
                                   textures, **kw)
    if not track:
        return out
    pix, depth, gid = out
    return pix, depth, torch.where(depth > 0, gid, NO_GID)
