"""Tiled rasterizer: binning, packed setup tables, and the ``raster_flat_nearest``
CUDA kernel with its plain PyTorch version.

Counterpart of the flat, nearest-sampling path of
``swift3drenderer_tpu.ops.raster_pallas``: ``pack_setup_tables``,
``bin_triangles``, ``_rasterize_chunk``'s ``ids_resident`` branch and the
``_raster_kernel`` it launches. The frame is cut into TILE_W x TILE_H pixel
tiles; each tile's list holds, in ascending order, the live slots whose bbox
touches it. The kernel (csrc/raster.cu) runs one thread block per tile and one
thread per pixel: visibility over the tile's list, then the winner's shading and
texel fetch, all in one launch as on the TPU.

Winners do not depend on the tiling: a pixel tests every live slot whose bbox
touches its tile in ascending slot order, and the exact bbox test is part of
coverage, so any slot left out of a tile's list would fail it anyway. The plain
version therefore walks all binned slots over the whole frame.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .. import kernels
from .setup import trunc_i32
from .texture import sample_ripmap, texel_index

# Row indices of the packed (43, S) float32 table (raster_pallas.py:54-58).
_W00, _DX, _DY, _RVZ = 0, 3, 6, 9          # 3 rows each: barycentric + 1/z
_CVP, _NP, _ATTRP = 12, 21, 30             # 9 rows each: corner-major premultiplied
_TPP, _DZV = 39, 41                        # 2 rows each: ripmap level constants
_F32_ROWS = 43
# Row indices of the packed (7, S) int32 table (raster_pallas.py:63-64).
# _GID is each slot's global setup index.
_XMIN, _XMAX, _YMIN, _YMAX, _TEXBASE, _ISTEX, _GID = 0, 1, 2, 3, 4, 5, 6
_I32_ROWS = 7

# The port's pixel tile: one warp spans one 32-pixel row, so output stores
# coalesce; 1080 and 2160 are multiples of 8, so the common frames have no
# ragged tiles. Thread block = one tile; csrc/raster.cu fixes the same shape
# (kTileW, kTileH).
TILE_W, TILE_H = 32, 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_setup_tables(setup: Dict[str, torch.Tensor]):
    """Pack the setup table into (row, slot) arrays: (43, S) f32, (7, S) i32.
    Row _GID holds each slot's own index (one pass covers the whole table)."""
    n = setup["live"].shape[0]
    dev = setup["live"].device
    f32 = torch.cat([
        setup["w00"].T, setup["dx"].T, setup["dy"].T, setup["rvz"].T,
        setup["cvp"].reshape(-1, 9).T,
        setup["np"].reshape(-1, 9).T,
        setup["attrp"].reshape(-1, 9).T,
        setup["tpp"].T, setup["dzv"].T,
    ], dim=0).to(torch.float32).contiguous()              # (43, S)
    i32 = torch.stack([
        setup["xmin"], setup["xmax"], setup["ymin"], setup["ymax"],
        torch.where(setup["is_tex"], setup["tex"] << 18, -1),
        setup["is_tex"].to(torch.int32),
        torch.arange(n, dtype=torch.int32, device=dev),
    ], dim=0).to(torch.int32).contiguous()                # (7, S)
    return f32, i32


def bin_triangles(setup: Dict[str, torch.Tensor], *, width: int, height: int,
                  tile_h: int, tile_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map each live triangle to the framebuffer tiles its bbox touches.

    Returns (ids (ntiles, S) int32 — touching triangle slots first, ascending;
    counts (ntiles, 1) int32). Ascending id order preserves the reference's
    earlier-triangle-wins depth ties.
    """
    dev = setup["live"].device
    ntx, nty = _cdiv(width, tile_w), _cdiv(height, tile_h)
    txmin = torch.clamp(torch.div(setup["xmin"], tile_w, rounding_mode="floor"),
                        0, ntx - 1)
    txmax = torch.clamp(torch.div(setup["xmax"], tile_w, rounding_mode="floor"),
                        0, ntx - 1)
    tymin = torch.clamp(torch.div(setup["ymin"], tile_h, rounding_mode="floor"),
                        0, nty - 1)
    tymax = torch.clamp(torch.div(setup["ymax"], tile_h, rounding_mode="floor"),
                        0, nty - 1)
    tx = torch.arange(ntx, dtype=torch.int32, device=dev)
    ty = torch.arange(nty, dtype=torch.int32, device=dev)
    touch_x = (tx[None, :] >= txmin[:, None]) & (tx[None, :] <= txmax[:, None])
    touch_y = (ty[None, :] >= tymin[:, None]) & (ty[None, :] <= tymax[:, None])
    # A live slot's bbox lies inside the frame (triangle_setup clamps it), so
    # unlike the banded JAX binner no row-band test is needed.
    touch = ((touch_y[:, :, None] & touch_x[:, None, :])
             & setup["live"][:, None, None])
    touch = touch.reshape(touch.shape[0], nty * ntx).T          # (ntiles, S)
    s = touch.shape[1]
    # Stable partition (touching slots first, both groups ascending) as a
    # sort of one unique key: untouched slots get their index + S.
    slot = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    keys = torch.where(touch, slot, slot + s)
    ids = (torch.sort(keys, dim=1).values % s).to(torch.int32).contiguous()
    counts = touch.sum(dim=1, dtype=torch.int32)[:, None].contiguous()
    return ids, counts


# ---------------------------------------------------------------------------
# The plain PyTorch version of raster_flat_nearest.

def _binned_slots(counts: torch.Tensor, ids: torch.Tensor) -> list:
    """Ascending list of every slot some tile's list holds."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return torch.unique(ids[pos < counts]).tolist()


def visibility_plain(counts: torch.Tensor, ids: torch.Tensor,
                     trf: torch.Tensor, tri: torch.Tensor, *, width: int,
                     height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 over the whole frame: (best 1/z (H, W) f32, winner slot (H, W)
    i32, -1 where nothing covers). Slots are walked in ascending order with
    the strict ``>`` update, so the earlier slot keeps a depth tie
    (render.swift:323-325)."""
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
    """Phase 2 for every pixel that has a winner: perspective-correct weights,
    halfway-vector headlight and the flat color pack. Returns (pixel rows,
    pixel columns, shade, packs, textured mask) over those pixels, and the
    inputs of phase 3's texel fetch over the textured ones: (texture index,
    uv (n, 2), ripmap level (n, 2))."""
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


def shade_plain(best: torch.Tensor, win: torch.Tensor, trf: torch.Tensor,
                tri: torch.Tensor, textures: torch.Tensor, *,
                background: int) -> torch.Tensor:
    """Phases 2 and 3 for every pixel that has a winner: the flat color pack,
    or the nearest texel fetch and shade multiply. Background elsewhere.
    Returns packed pixels (H, W) int32."""
    pix = torch.full(best.shape, background, dtype=torch.int32,
                     device=best.device)
    yy, xx, sh, out, tx, tex, uv, level = _shade_winners(best, win, trf, tri)
    if bool(tx.any()):
        rgb = sample_ripmap(textures, tex, uv, level)
        out[tx] = _pack(sh[tx], rgb[:, 0], rgb[:, 1], rgb[:, 2])
    pix[yy, xx] = out
    return pix


def fetched_texels(best: torch.Tensor, win: torch.Tensor, trf: torch.Tensor,
                   tri: torch.Tensor, num_textures: int) -> torch.Tensor:
    """The distinct atlas words the frame's textured winners fetch, as
    ascending flat indices into ``textures.reshape(-1)``: what
    ``raster_flat_nearest`` must read of the atlas."""
    *_, tex, uv, level = _shade_winners(best, win, trf, tri)
    return torch.unique(texel_index(tex, uv, level, num_textures))


def raster_flat_nearest_plain(counts, ids, trf, tri, textures, *, width: int,
                              height: int, background: int):
    """Plain PyTorch version of the ``raster_flat_nearest`` kernel: same
    inputs, same (pixels (H, W) int32, depth (H, W) f32)."""
    best, win = visibility_plain(counts, ids, trf, tri, width=width,
                                 height=height)
    return shade_plain(best, win, trf, tri, textures,
                       background=background), best


# ---------------------------------------------------------------------------
# The kernel's wrapper.

@functools.cache
def _kernel():
    fn = kernels.library().raster_flat_nearest
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def raster_flat_nearest(counts: torch.Tensor, ids: torch.Tensor,
                        trf: torch.Tensor, tri: torch.Tensor,
                        textures: torch.Tensor, *, width: int, height: int,
                        background: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility, deferred shading and nearest texel fetch for one frame.

    counts (ntiles, 1) i32 and ids (ntiles, S) i32 from ``bin_triangles`` at
    TILE_W x TILE_H; trf (43, S) f32 and tri (7, S) i32 from
    ``pack_setup_tables``; textures (NT, 512, 512) i32. Returns (pixels (H, W)
    int32 holding 0x00RRGGBB, depth (H, W) f32 = 1/z, 0 where empty).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``raster_flat_nearest.launches`` counts the kernel's launches.
    """
    dev = trf.device
    if dev.type == "cpu":
        return raster_flat_nearest_plain(counts, ids, trf, tri, textures,
                                         width=width, height=height,
                                         background=background)
    if dev.type != "cuda":
        raise ValueError(f"raster_flat_nearest runs on cpu or cuda, not {dev}")
    s = trf.shape[1]
    ntx, nty = _cdiv(width, TILE_W), _cdiv(height, TILE_H)
    nt = textures.shape[0]
    _check(counts, "counts", torch.int32, (ntx * nty, 1), dev)
    _check(ids, "ids", torch.int32, (ntx * nty, s), dev)
    _check(trf, "trf", torch.float32, (_F32_ROWS, s), dev)
    _check(tri, "tri", torch.int32, (_I32_ROWS, s), dev)
    _check(textures, "textures", torch.int32, (nt, 512, 512), dev)
    pix = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _kernel()(
            counts.data_ptr(), ids.data_ptr(), trf.data_ptr(), tri.data_ptr(),
            textures.data_ptr(), pix.data_ptr(), depth.data_ptr(),
            s, nt, width, height, background,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"raster_flat_nearest launch failed: {kernels.error_string(err)}")
    raster_flat_nearest.launches += 1
    return pix, depth


raster_flat_nearest.launches = 0


def rasterize(setup: Dict[str, torch.Tensor], textures: torch.Tensor, *,
              width: int, height: int,
              background: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin, pack and rasterize one frame: (pixels (H, W) int32, depth (H, W)
    f32). The host side of ``rasterize_pallas`` for single-pass scenes."""
    ids, counts = bin_triangles(setup, width=width, height=height,
                                tile_h=TILE_H, tile_w=TILE_W)
    trf, tri = pack_setup_tables(setup)
    return raster_flat_nearest(counts, ids, trf, tri, textures, width=width,
                               height=height, background=background)
