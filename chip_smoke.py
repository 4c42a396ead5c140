#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swift3drenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR]

Phases; any failed check raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (nvcc, sm_90a; one nvcc for each of
     raster.cu and probes.cu, and for each measurement build of raster.cu,
     started together), printing each kernel's registers, shared memory and
     spills;
  3. hold each kernel against its plain PyTorch version on the card, bit for
     bit: raster_flat_nearest and raster_flat_bilinear on the default
     scene's tables at 1920x1080 and 3840x2160 and the other small scene
     families at a ragged 1366x768; raster_segmented_nearest and
     raster_segmented_bilinear on stress_scene(objects=840) at both sizes and
     stress100k at 1920x1080 (nearest also regular_floor and stress100k at
     1366x768), and against the flat kernels on the default scene; each
     kernel's batched launch (B = 4) against its launches frame by frame;
     each kernel's tracking form (the winners' gid plane) against its plain
     version, pixels, depth and gids, and its pixels and depth against the
     kernel's own, on the default scene, stress 840 and stress100k at
     1920x1080, the icosahedron bilinear and B = 4 batches; and frames cut
     into 2, 4 and 8 bands (y_offset > 0), stitched, against the full frame,
     all four kernels; and the segmented kernels' lists at other K and G
     (G = 1, 4, 16; K = 4) on a ragged frame and on a band, untracked and
     tracked;
  4. drive the main paths through Renderer(..., device="cuda"), each with the
     launch counts of all four kernels set to 0 just before and read just
     after: the default scene and the 840-object stress field over bench.py's
     20-pose flight at both sizes, stress100k over its first 5 poses at
     1920x1080; with bilinear sampling the icosahedron scene (config 2) and
     stress 840 at 1920x1080 and the default scene at both sizes; and the
     serving path, Renderer.render_batch, on the default scene (B = 4,
     1920x1080, the flight in 5 calls) and the tetrahedron (B = 8, 640x480,
     config 1), every batch frame bit-equal to its single-frame render; then
     hold the card's output against the plain CPU path on small frames (one
     of them ragged), single frames and batches, nearest and bilinear; then
     the multi-device paths: render_scene_sharded on an NCCL group of one
     rank and ShardedRenderer.render_batch on a 1 x 1 mesh (one card holds
     one NCCL rank), and the N-rank composites run as N per-range
     pipelines (renderer.render_range, each the device work of one rank)
     merged with merge_depth_gid, N = 2, 4, 8, on the default scene, stress
     840 and stress100k at 1920x1080 and, bilinear, the icosahedron and
     stress 840, and render_batch_sharded's 2 x 4 grid as its eight rank
     blocks: each bit-equal to the single-card render;
  5. time, with CUDA events after a warm-up: each cell's frame (or batch
     call), the front-end stages, its kernel (with the L2 cache cold, as a
     frame finds it) and plain version, beside the least time the card could
     take for the same work; the segmented binner's tile and super-tile
     entries, residual broadband slots, sort, binner and kernel times for
     several K at the default G and several G at the default K; the phase
     split of the segmented kernels (each launch with its broadband lists,
     its segments or both emptied) on stress 840 at both sizes and
     stress100k at 1920x1080; the default scene through either route
     (flat, or segmented with the flat route's slot limit lifted): frames
     (bit-equal), binners and kernels; and the batch sweep B = 1, 2, 4, 8 at
     both sizes: ms per frame, kernels per call and the card's busy share;
     each tracking form against its kernel with the L2 cold, the per-range
     pipeline at N = 1, 2, 4, 8 (the device work of one rank of an N-card
     deployment) and merge_depth_gid; with --parent DIR (a checkout of the
     parent commit), the four kernels and their tracking forms at y0 = 0
     against the parent tree's (the segmented ones at the split's cells and
     at 3840x2160 with this tree's G = 1, every wide slot residual), the
     split of both trees, L2 cold, and each tree's whole frame (default,
     stress 840 at both sizes) and segmented binning, in turns parent,
     this, this, parent;
  6. the share of each flight's wall time the card is busy, each kernel's
     device time per frame in the flight, and the device-to-host copies the
     flight makes (must be none), from torch.profiler; each route's device
     time per frame of the default scene's flight; and the same copy check
     over the 8-rank composites (per-range pipelines and merges).
  7. the probes (swift3drenderer_tpu_torch.tools, csrc/probes.cu): each
     probe's main(device="cuda") with its launch count set to 0 just before
     and read just after (every mode checked against the tool's oracle and
     timed at the tool's full ITERS); every mode's kernel against its plain
     version on the card, bit for bit, at 1, 3, 64, 130 iterations and the
     full ITERS, and the dynamic grid at nc = 0-4 with nc in device memory;
     torch.profiler shows the dynamic-grid call makes no device-to-host copy;
     `cuobjdump -sass` counts each instance's global loads inside its loop.

The line before the last is one JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

RESOLUTIONS = ((1920, 1080), (3840, 2160))
FLIGHT_POSES = 20          # bench.py's flight: Input(up=1.0, mouse=(2.0*i, 0))
POSES_100K = 5             # stress100k: the flight's first poses, at 1080p
SMALL = (320, 240)         # the CPU reference frame size
RAGGED_SMALL = (333, 217)  # neither a multiple of the 32 x 8 tile
RAGGED = (1366, 768)       # 1366 is not a multiple of 32
STRESS_OBJECTS = 840       # bench.py's stress row: 10,083 triangles
SEG_K_SWEEP = (2, 4, 8, 16, 32)
SEG_G_SWEEP = (1, 4, 8, 16)
CONFIG1 = (640, 480)       # BASELINE config 1: the tetrahedron at B = 8
BATCH_SWEEP = (1, 2, 4, 8)
SWEEP_FRAMES = 16          # frames rendered per batch-sweep setting
MISMATCH_BOUND = 5e-4      # test_pallas_matches_xla's bound, tol 1
DEPTH_RTOL = 1e-4
KERNELS = ("raster_flat_nearest", "raster_segmented_nearest",
           "raster_flat_bilinear", "raster_segmented_bilinear")
# The kernels' tracking forms (the same wrappers with track_ids=True,
# counted in .launches_ids).
FORMS = KERNELS + tuple(f"{k}_ids" for k in KERNELS)
# Each form's name in a profiler trace (the template instance it launches).
TRACE_NAMES = {f"raster_{route}_{sampling}{ids}":
               f"raster_{route}_kernel<{str(sampling == 'bilinear').lower()}, "
               f"{str(bool(ids)).lower()}>"
               for route in ("flat", "segmented")
               for sampling in ("nearest", "bilinear") for ids in ("", "_ids")}
GID_BASE = 500             # tracking checks: gids 2 * GID_BASE + slot
SCENE_RANKS = (2, 4, 8)    # the emulated triangle-sharded composites
RANGE_RANKS = (1, 2, 4, 8)
BANDS = (2, 4, 8)
GRID = (2, 4)              # render_batch_sharded's (frame, fb) grid

# Published NVIDIA H100 SXM peaks (data sheet; at the full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Arithmetic of the raster kernels, counted from their source: 12 flops for
# the three edge functions and 5 for 1/z per (pixel, slot whose bbox holds
# the pixel); about 100 for the winner's shading (weights, three
# interpolations, three normalisations, headlight, level select and pack),
# and 35 more for a bilinear texel (wrap, taps and weights per axis, four
# weights, three 4-tap channel sums).
VIS_FLOPS = 17
SHADE_FLOPS = {"nearest": 100, "bilinear": 135}
TABLE_WORDS = 43 + 7       # the f32 and i32 table rows of one slot


class SmokeFailure(Exception):
    pass


def reset_launches(raster) -> None:
    for k in KERNELS:
        getattr(raster, k).launches = 0
        getattr(raster, k).launches_ids = 0


def read_launches(raster) -> dict:
    """Each form's launch count: a kernel's wrapper counts its plain launches
    in .launches and its tracking ones in .launches_ids."""
    out = {k: getattr(raster, k).launches for k in KERNELS}
    out.update({f"{k}_ids": getattr(raster, k).launches_ids for k in KERNELS})
    return out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def pixel_mismatch_fraction(a: np.ndarray, b: np.ndarray, tol: int = 1) -> float:
    """Fraction of pixels whose packed RGB differs by more than ``tol`` in any
    channel (copy of tests/conftest.py)."""
    assert a.shape == b.shape

    def channels(p):
        p = p.astype(np.int64)
        return np.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], axis=-1)

    diff = np.abs(channels(a) - channels(b)).max(axis=-1)
    return float((diff > tol).mean())


def max_channel_err(a: np.ndarray, b: np.ndarray) -> int:
    ca = np.stack([(a.astype(np.int64) >> k) & 255 for k in (16, 8, 0)])
    cb = np.stack([(b.astype(np.int64) >> k) & 255 for k in (16, 8, 0)])
    return int(np.abs(ca - cb).max())


def compare(pix_a, depth_a, pix_b, depth_b, what: str) -> dict:
    """Hold one (pixels, depth) pair (a frame or a batch) against another:
    raise past the bounds, or where the two are not equal bit for bit."""
    pa = pix_a.cpu().numpy().view(np.uint32) if hasattr(pix_a, "cpu") else pix_a
    pb = pix_b.cpu().numpy().view(np.uint32) if hasattr(pix_b, "cpu") else pix_b
    da = depth_a.cpu().numpy() if hasattr(depth_a, "cpu") else depth_a
    db = depth_b.cpu().numpy() if hasattr(depth_b, "cpu") else depth_b
    check(pa.shape == pb.shape and da.shape == db.shape, f"{what}: shapes differ")
    mis = pixel_mismatch_fraction(pa, pb)
    both = (da > 0) & (db > 0)
    rel = float(np.max(np.abs(da[both] - db[both]) / db[both])) if both.any() else 0.0
    out = {"pixel_mismatch": mis, "max_channel_err": max_channel_err(pa, pb),
           "depth_max_abs_err": float(np.max(np.abs(da - db))),
           "depth_max_rel_err": rel,
           "coverage_differs": int(((da > 0) != (db > 0)).sum()),
           "bit_equal": bool(np.array_equal(pa, pb) and np.array_equal(da, db))}
    check(mis < MISMATCH_BOUND, f"{what}: pixel mismatch {mis} >= {MISMATCH_BOUND}")
    check(rel <= DEPTH_RTOL, f"{what}: depth rel err {rel} > {DEPTH_RTOL}")
    check(out["bit_equal"], f"{what}: not bit-equal ({json.dumps(out)})")
    return out


def time_cold_ms(torch, fn, reps: int = 50, warmup: int = 3,
                 flush_bytes: int = 512 << 20) -> float:
    """Device ms of one call of ``fn`` with the L2 cache cold, as a frame's
    launch finds it: a buffer ten times the H100's 50 MB L2 is written before
    each call, outside the timed span (writing it takes longer than the host
    needs to enqueue ``fn``, so the span holds no idle gap). Median over
    ``reps`` calls, after ``warmup`` calls."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    spans = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in spans)


def time_ms(torch, fn, reps: int, warmup: int = 5, windows: int = 5) -> float:
    """Device ms per call of ``fn``: the median over ``windows`` windows of
    the mean over ``reps`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_window = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_window.append(start.elapsed_time(end) / reps)
    return statistics.median(per_window)


def device_busy(torch, fn) -> dict:
    """From the events of a torch.profiler trace of one call of ``fn``: the
    share of its wall time the card spends in kernels, the number of kernels
    launched, each kernel's device time (µs summed over the window, by name),
    and the device-to-host copies and scalar reads (``_local_scalar_dense``)
    the host made. ``busy`` is "not measured" if the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    launched = d2h = scalar_reads = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "DtoH" in e.name or "Device -> Pageable" in e.name:
                d2h += 1
                continue
            if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
                continue
            launched += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
        elif e.name in ("aten::_local_scalar_dense", "aten::item"):
            scalar_reads += 1
    total = sum(per_kernel.values())
    return {"busy": total / wall_us if total > 0 else "not measured",
            "launched": launched, "per_kernel": per_kernel, "d2h": d2h,
            "scalar_reads": scalar_reads}


def flight(Camera, Input, n: int):
    cam = Camera()
    return [cam.update(Input(up=1.0, mouse=(2.0 * i, 0.0)),
                       force_update=(i == 0)).copy() for i in range(n)]


def bound_of(nbytes: int, flops: int) -> dict:
    """The least time for ``nbytes`` and ``flops``: the larger of bytes over
    the HBM rate and fp32 flops over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def work_bound(raster, tile_slots, ids_read, slots, best, win, trf, tri,
               textures, width, height, list_bytes, sampling) -> dict:
    """Least time the card could take for a raster kernel's work on one
    frame's inputs: ``bound_of`` its bytes and flops. Bytes, as this frame's
    data needs them: the per-tile list bounds (``list_bytes``); the
    ``ids_read`` slot ids the tiles' lists hold; the table columns of the
    distinct binned ``slots``; the distinct atlas words the textured winners
    fetch (one per winner for nearest, the four taps for bilinear; found by
    the plain version); both output planes written once. Flops: for each
    binned slot, the pixels its bbox holds (the only pixels whose edge
    functions the frame needs); plus the shading of every pixel with a
    winner. ``tile_flops`` is the coarser count of the kernels' 32 x 8
    tiles, for comparison: each tile's pixels times ``tile_slots``, the slots
    whose bbox touches the tile."""
    tile_w, tile_h = raster.TILE_W, raster.TILE_H
    ntx = -(-width // tile_w)
    ty, tx = np.divmod(np.arange(tile_slots.size), ntx)
    tile_px = (np.minimum(tile_w, width - tx * tile_w)
               * np.minimum(tile_h, height - ty * tile_h))
    slots = slots.long()
    x0, x1, y0, y1 = (tri[r][slots].long() for r in (
        raster._XMIN, raster._XMAX, raster._YMIN, raster._YMAX))
    bbox_px = int(((x1.clamp(max=width - 1) - x0.clamp(min=0) + 1).clamp(min=0)
                   * (y1.clamp(max=height - 1) - y0.clamp(min=0) + 1).clamp(min=0)
                   ).sum())
    covered = int((win >= 0).sum().item())
    texels = int(raster.fetched_texels(best, win, trf, tri, textures.shape[0],
                                       sampling).numel())
    nbytes = (list_bytes + ids_read * 4 + slots.numel() * TABLE_WORDS * 4
              + texels * 4 + width * height * 8)
    flops = VIS_FLOPS * bbox_px + SHADE_FLOPS[sampling] * covered
    tile_flops = (VIS_FLOPS * int((tile_slots * tile_px).sum())
                  + SHADE_FLOPS[sampling] * covered)
    return {**bound_of(nbytes, flops), "atlas_words_fetched": texels,
            "bbox_slots_per_pixel": bbox_px / (width * height),
            "tile_flops": tile_flops,
            "tile_bound_ms": bound_of(nbytes, tile_flops)["bound_ms"],
            "binned_slots_per_pixel": float((tile_slots * tile_px).sum()
                                            / (width * height))}


def flat_bound(raster, counts, ids, trf, tri, textures, width, height,
               sampling) -> dict:
    """work_bound of a flat kernel on one frame: each tile's list is its
    binned slots."""
    c = counts.reshape(-1).to("cpu").numpy().astype(np.int64)
    best, win = raster.visibility_plain(counts, ids, trf, tri, width=width,
                                        height=height)
    binned = ids.new_tensor(raster._binned_slots(counts, ids))
    return work_bound(raster, c, int(c.sum()), binned, best, win, trf, tri,
                      textures, width, height, c.size * 4, sampling)


def segmented_bound(raster, binned, trf, tri, rec, textures, width, height,
                    sampling) -> dict:
    """work_bound of a segmented kernel on one frame: a tile's slots are
    those of its lists whose bbox touches it (its segment, and of its
    super-tile's segment and the residual broadband list); walking the
    slots that miss the tile is the design's cost, not the work's, and
    each (tile, slot) pair counts once, whichever list holds it."""
    ids, starts, counts, bb, bb_count, bb_box = binned
    tiles, slots = raster.segmented_pairs(*binned, tri, width=width,
                                          height=height)
    ntiles = raster.seg_lists(width, height)[0]
    tile_slots = np.bincount(tiles.to("cpu").numpy(), minlength=ntiles)
    entries = int(counts[:ntiles].sum().item())
    super_entries = int(counts[ntiles:].sum().item())
    wide = int(bb_count[0].item())
    best, win = raster.visibility_segmented_plain(*binned, trf, tri,
                                                  width=width, height=height)
    out = work_bound(raster, tile_slots, entries + super_entries + wide,
                     slots.unique(), best, win, trf, tri, textures, width,
                     height, counts.numel() * 8 + 4, sampling)
    return {**out, "entries": entries, "super_tile_entries": super_entries,
            "broadband_slots": wide}


def load_parent_raster(parent: str):
    """``ops.raster`` of the port in another checkout (the parent commit's),
    imported as package ``s3d_parent``: its kernels build from its own
    csrc/ into its own _build/. A tree from before the slot records, whose
    segmented kernels take no ``rec``, is wrapped to take this tree's
    arguments: its ``pack_slot_records`` gives None, which its segmented
    kernels drop."""
    import importlib
    import importlib.util
    import os
    import types

    pkg = os.path.join(os.path.abspath(parent), "swift3drenderer_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "s3d_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules["s3d_parent"] = module
    spec.loader.exec_module(module)
    r = importlib.import_module("s3d_parent.ops.raster")
    if hasattr(r, "pack_slot_records"):
        return r
    shim = types.SimpleNamespace(**vars(r))
    shim.pack_slot_records = lambda setup: None
    for sampling in ("nearest", "bilinear"):
        launch = getattr(r, f"raster_segmented_{sampling}")
        # (ids, starts, counts, bb, bb_count, trf, tri, rec, textures)
        setattr(shim, f"raster_segmented_{sampling}",
                lambda *a, _launch=launch, **kw: _launch(*a[:7], *a[8:], **kw))
    return shim


# The phase split of the segmented kernels: stress 840 at both sizes and
# stress100k at 1080p, each launch timed L2 cold with some of its lists
# emptied (measurement inputs only; the emptied launches' outputs are thrown
# away). "broadband" is every list a tile filters by bbox (the parent's
# frame-wide list; here the super-tile segments and the residual list),
# "residual" the frame-wide list alone, "segments" the tiles' own segments.
SPLIT_CELLS = (("stress840", 1920, 1080), ("stress840", 3840, 2160),
               ("stress100k", 1920, 1080))
SPLIT_WAYS = ("full", "no_broadband", "no_residual", "no_segments", "neither")


def tree_tables(r, route: str, setup, gids=None) -> tuple:
    """The tables a tree's kernels take after the bins: (trf, tri), and for
    the segmented kernels (trf, tri, rec)."""
    trf, tri = r.pack_setup_tables(setup, gids)
    if route == "segmented":
        return trf, tri, r.pack_slot_records(setup)
    return trf, tri


def tree_binned(r, route: str, setup, width: int, height: int,
                y_offset: int = 0, **seg) -> tuple:
    """A tree's binner outputs for its route's kernels, in their order, over
    the band [y_offset, y_offset + height); ``seg`` (k, g) goes to the
    segmented binner."""
    if route == "flat":
        return r.bin_triangles(setup, width=width, height=height,
                               tile_h=r.TILE_H, tile_w=r.TILE_W,
                               y_offset=y_offset)[::-1]
    return r.bin_segments(setup, width=width, height=height,
                          y_offset=y_offset, **seg)


def emptied(binned, ntiles: int, way: str):
    """``bin_segments``' outputs (ids, starts, counts, bb, bb_count, ...)
    with the lists of ``way`` emptied: counts past the ``ntiles`` tiles are
    the super-tiles'."""
    ids, starts, counts, bb, bb_count, *rest = binned
    counts, bb_count = counts.clone(), bb_count.clone()
    if way in ("no_broadband", "neither"):
        counts[..., ntiles:] = 0
    if way in ("no_broadband", "no_residual", "neither"):
        bb_count.zero_()
    if way in ("no_segments", "neither"):
        counts[..., :ntiles] = 0
    return (ids, starts, counts, bb, bb_count, *rest)


def segmented_split(torch, trees: dict, setups: dict, textures: dict,
                    bg: int, reps: int = 30) -> list:
    """Phase split of the segmented kernels of each tree ({"parent": its
    ops.raster, "this": ours}) on the same setup tables (``setups``:
    {(scene, width, height): setup}): each way of SPLIT_WAYS timed L2 cold
    in turns parent, this, this, parent (this alone without a parent); the
    shares of the full launch that emptying each part saves."""
    order = (["parent", "this", "this", "parent"] if "parent" in trees
             else ["this"])
    tw, th = trees["this"].TILE_W, trees["this"].TILE_H
    out = []
    for (scene, width, height), setup in setups.items():
        ntiles = -(-width // tw) * -(-height // th)
        kw = dict(width=width, height=height, background=bg)
        for sampling in ("nearest", "bilinear"):
            args = {}
            for who, r in trees.items():
                binned = tree_binned(r, "segmented", setup, width, height)
                tables = tree_tables(r, "segmented", setup)
                args[who] = {way: (*emptied(binned, ntiles, way), *tables,
                                   textures[scene]) for way in SPLIT_WAYS}
            spans = {(who, way): [] for who in trees for way in SPLIT_WAYS}
            for who in order:
                launch = getattr(trees[who], f"raster_segmented_{sampling}")
                for way in SPLIT_WAYS:
                    spans[who, way].append(time_cold_ms(
                        torch, lambda: launch(*args[who][way], **kw), reps=reps))
            for who in trees:
                ms = {way: statistics.median(spans[who, way])
                      for way in SPLIT_WAYS}
                res = {"tree": who, "scene": scene, "at": f"{width}x{height}",
                       "sampling": sampling, "ms": ms,
                       "broadband_share": 1 - ms["no_broadband"] / ms["full"],
                       "residual_share": 1 - ms["no_residual"] / ms["full"],
                       "segments_share": 1 - ms["no_segments"] / ms["full"],
                       "rest_share": ms["neither"] / ms["full"]}
                out.append(res)
                print(f"split: {json.dumps(res)}", flush=True)
    return out


PROBE_ITERS = (1, 3, 64, 130)   # small counts, beside each tool's full ITERS
PROBE_MIXES = (0, 127)
PROBE_CHUNKS = (0, 1, 2, 3, 4)
DYNAMIC_CALLS = 20
PROBE_FAMILIES = {"probe_gather2d": "probe_gather2d_kernel",
                  "probe_packed_fetch": "probe_packed_fetch_kernel",
                  "fetch_microbench": "fetch_microbench_kernel",
                  "probe_dynamic_grid": "probe_dynamic_grid_kernel"}


def sass_loops(path: str) -> dict:
    """From ``cuobjdump -sass`` of a built library, for each kernel (by its
    mangled name): the instructions inside its loops (from a backward
    branch's target to the branch), the global loads (LDG) among them, and
    its global loads in all. {"error": ...} if cuobjdump is missing or
    fails."""
    import os
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        proc = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, timeout=120)
    except OSError as e:
        return {"error": f"not measured: {e}"}
    if proc.returncode:
        return {"error": f"not measured: {proc.stderr.strip()[:200]}"}

    def opcode(text):
        words = text.split()
        return words[1] if words[0].startswith("@") else words[0]

    out = {}
    for chunk in proc.stdout.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        instrs, labels = [], {}
        for line in chunk.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                labels[label.group(1)] = len(instrs)
                continue
            ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
            if ins:
                instrs.append((int(ins.group(1), 16), ins.group(2)))
        at = {addr: i for i, (addr, _) in enumerate(instrs)}
        in_loop = set()
        for i, (_, text) in enumerate(instrs):
            branch = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", text)
            if not branch:
                continue
            target = branch.group(1)
            j = (labels.get(target) if target.startswith(".L")
                 else at.get(int(target, 16)))
            if j is not None and j <= i:
                in_loop.update(range(j, i + 1))
        loads = [i for i, (_, text) in enumerate(instrs)
                 if opcode(text).startswith("LDG")]
        out[name] = {"loop_instructions": len(in_loop),
                     "global_loads_in_loops": sum(i in in_loop for i in loads),
                     "global_loads": len(loads)}
    return out


def probe_sass(sass: dict, probe: str, mode_index: int | None) -> dict:
    """The sass_loops entry of one probe kernel instance (its template
    argument is the mode's index), or "not measured"."""
    import re
    for name, entry in sass.items():
        if PROBE_FAMILIES[probe] not in name:
            continue
        arg = re.search(r"ILi(\d+)E", name)
        if mode_index is None or (arg and int(arg.group(1)) == mode_index):
            return entry
    return {"error": sass.get("error", "not measured: instance not found")}


def probes_phase(torch) -> list:
    """Phase 7: the probes' entry points, their kernels against the plain
    versions, the dynamic grid's copy check, and one kernels-line row each."""
    from swift3drenderer_tpu_torch import kernels
    from swift3drenderer_tpu_torch.tools import (
        fetch_microbench, probe_dynamic_grid, probe_gather2d,
        probe_packed_fetch)

    modules = {"probe_gather2d": probe_gather2d,
               "probe_packed_fetch": probe_packed_fetch,
               "fetch_microbench": fetch_microbench,
               "probe_dynamic_grid": probe_dynamic_grid}
    wrappers = {name: getattr(m, name) for name, m in modules.items()}
    plains = {name: getattr(m, f"{name}_plain") for name, m in modules.items()}

    # The probes' main path: each tool's entry point, its count set to 0
    # just before and read just after.
    results, launches = {}, {}
    for name, module in modules.items():
        wrappers[name].launches = 0
        results[name] = module.main("cuda")
        launches[name] = wrappers[name].launches
        per_mode = [r["launches"] for r in results[name].values()]
        check(launches[name] == sum(per_mode) and min(per_mode) > 0,
              f"{name}: {launches[name]} launches, per mode {per_mode}")

    # Every mode's kernel against its plain version on the card; ``full``
    # holds each mode's call at the tool's full count (the timed one).
    def count(n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")

    g2 = probe_gather2d.inputs("cuda")
    pf = probe_packed_fetch.inputs("cuda")
    mb = fetch_microbench.inputs("cuda")
    tab, hbm = probe_dynamic_grid.inputs("cuda")
    full = {"probe_gather2d": {m: (m, *g2[m], probe_gather2d.ITERS)
                               for m in probe_gather2d.MODES},
            "probe_packed_fetch": {m: (m, *pf[m], probe_packed_fetch.TIMED_MIX,
                                       probe_packed_fetch.ITERS)
                                   for m in probe_packed_fetch.MODES},
            "fetch_microbench": {m: (m, *mb, fetch_microbench.ITERS)
                                 for m in fetch_microbench.MODES},
            "probe_dynamic_grid": {n: (tab, hbm, count(n))
                                   for n in probe_dynamic_grid.CHUNKS}}
    counts_of = {name: PROBE_ITERS + (modules[name].ITERS,)
                 for name in ("probe_gather2d", "probe_packed_fetch",
                              "fetch_microbench")}
    cases = {
        "probe_gather2d": [(m, *g2[m], n) for m in probe_gather2d.MODES
                           for n in counts_of["probe_gather2d"]],
        "probe_packed_fetch": [(m, *pf[m], mix, n)
                               for m in probe_packed_fetch.MODES
                               for mix in PROBE_MIXES
                               for n in counts_of["probe_packed_fetch"]],
        "fetch_microbench": [(m, *mb, n) for m in fetch_microbench.MODES
                             for n in counts_of["fetch_microbench"]],
        "probe_dynamic_grid": [(tab, hbm, count(n)) for n in PROBE_CHUNKS]}
    errs = {}
    for name, args_list in cases.items():
        errs[name] = 0
        for args in args_list:
            got, want = wrappers[name](*args), plains[name](*args)
            err = (got.double() - want.double()).abs().max().item()
            what = [a if isinstance(a, (str, int)) else tuple(a.shape) for a in args]
            check(torch.equal(got, want), f"{name} {what}: kernel and plain "
                  f"version differ (max abs err {err})")
            errs[name] = max(errs[name], err)
        print(f"probe {name}: kernel == plain version, bit for bit, in "
              f"{len(args_list)} calls", flush=True)

    # The dynamic grid's launch is a few microseconds, shorter than the
    # wrapper's host work, so its device time comes from the profiler's
    # trace of DYNAMIC_CALLS back-to-back calls at each count; the trace
    # also shows the calls copy nothing to the host.
    device_ms = {}
    for n, args in full["probe_dynamic_grid"].items():
        prof = device_busy(torch, lambda: [probe_dynamic_grid.probe_dynamic_grid(
            *args) for _ in range(DYNAMIC_CALLS)])
        us = sum(v for k, v in prof["per_kernel"].items()
                 if PROBE_FAMILIES["probe_dynamic_grid"] in k)
        device_ms[n] = us / DYNAMIC_CALLS / 1e3 if us else "not measured"
        print(f"profile probe_dynamic_grid nc={n}: {device_ms[n]} ms of device "
              f"time per launch, device-to-host copies {prof['d2h']}, scalar "
              f"reads {prof['scalar_reads']}", flush=True)
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"probe_dynamic_grid nc={n}: the calls copied to the host")

    sass = sass_loops(kernels.library_path(kernels.PROBES))
    works = {"probe_gather2d": lambda m, a: probe_gather2d.work(m, a[1], a[2], a[-1]),
             "probe_packed_fetch": lambda m, a: probe_packed_fetch.work(m, a[2], a[-1]),
             "fetch_microbench": lambda m, a: fetch_microbench.work(m, a[2], a[-1]),
             "probe_dynamic_grid": lambda nc, a: probe_dynamic_grid.work(nc)}
    replaces = {"probe_gather2d": "tools/probe_gather2d.py:124",
                "probe_packed_fetch": "tools/probe_packed_fetch.py:103",
                "fetch_microbench": "tools/fetch_microbench.py:77",
                "probe_dynamic_grid": "tools/probe_dynamic_grid.py:52"}
    main_mode = {"probe_gather2d": "base8", "probe_packed_fetch": "gather8",
                 "fetch_microbench": "full",
                 "probe_dynamic_grid": f"nc={probe_dynamic_grid.NCMAX}"}
    rows = []
    for name, module in modules.items():
        modes = []
        for mode, res in results[name].items():
            args = full[name][mode]
            plain_ms = time_ms(torch, lambda: plains[name](*args), reps=3,
                               warmup=1, windows=3)
            entry = {"mode": mode if isinstance(mode, str) else f"nc={mode}",
                     "ms": device_ms.get(mode, res["ms"]), "call_ms": res["ms"],
                     "plain_ms": plain_ms,
                     "launches": res["launches"],
                     **bound_of(*works[name](mode, args))}
            if "ns_per_iter" in res:
                entry["ns_per_iter"] = res["ns_per_iter"]
                entry["net_ns_per_iter"] = res.get(
                    "net_ns_per_iter", "the tool has no empty mode")
                entry["sass"] = probe_sass(sass, name, module.MODES.index(mode))
            else:
                entry["sass"] = probe_sass(sass, name, None)
            modes.append(entry)
        main = next(e for e in modes if e["mode"] == main_mode[name])
        rows.append({
            "name": name, "route": "cuda",
            "source": "swift3drenderer_tpu_torch/csrc/probes.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name],
            "tolerance": "bit-equal (checked)",
            "at": f"{main['mode']}, the tool's shapes and full count",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_note": "int32 lane ops counted at the fp32 lane rate "
                          "(an optimistic peak)",
            "library_ms": None, "modes": modes})
        for e in modes:
            print(f"probe {name} {e['mode']}: {e['ms']} ms, ns/iter "
                  f"{e.get('ns_per_iter', '-')} (net "
                  f"{e.get('net_ns_per_iter', '-')}), plain {e['plain_ms']} ms, "
                  f"bound {e['bound_ms']} ms ({e['bound_by']}), launches "
                  f"{e['launches']}, sass {json.dumps(e['sass'])}", flush=True)
    return rows


def run(parent: str | None = None) -> dict:
    import torch

    t_start = time.perf_counter()

    def phase(name):
        print(f"== {name} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    # ---- 1. device ----
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)

    from swift3drenderer_tpu_torch import Camera, Input, RenderConfig, kernels
    from swift3drenderer_tpu_torch.config import DEFAULT_CONFIG
    from swift3drenderer_tpu_torch.models import SCENES, default_scene
    from swift3drenderer_tpu_torch.ops import raster
    from swift3drenderer_tpu_torch.parallel import (
        Mesh, ShardedRenderer, make_mesh, merge_depth_gid,
        render_batch_sharded, render_scene_sharded)
    from swift3drenderer_tpu_torch.renderer import (
        Renderer, build_setup, render_range, scene_to_device)

    # ---- 2. build ----
    phase("2. build")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    for source, log in logs.items():
        print(f"build: csrc/{source} {'compiled' if log else 'already built'} "
              f"(all sources in {build_s:.2f} s)", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {line.strip()}")

    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    bilinear = RenderConfig(sampling="bilinear")
    bg = cfg.background_packed
    poses = flight(Camera, Input, FLIGHT_POSES)
    poses40 = flight(Camera, Input, 40)
    scenes = {"default": default_scene(seed=0),
              "stress840": SCENES["stress"](seed=0, objects=STRESS_OBJECTS),
              "stress100k": SCENES["stress100k"](seed=0),
              "icosahedron": SCENES["icosahedron"](seed=0),
              "tetrahedron": SCENES["tetrahedron"](seed=0)}
    arrays = {name: scene_to_device(sc, dev) for name, sc in scenes.items()}
    for name, sc in scenes.items():
        print(f"scene {name}: {sc.num_triangles} triangles, "
              f"{2 * sc.num_triangles} slots", flush=True)

    def setup_of(m, width, height, arr):
        """The setup table of one frame (m (3, 4)) or a batch (B, 3, 4)."""
        return build_setup(arr, torch.as_tensor(np.asarray(m), device=dev),
                           width=width, height=height, config=cfg)

    def flat_tables(m, width, height, arr):
        """The setup table, and the flat kernels' inputs."""
        setup = setup_of(m, width, height, arr)
        ids, counts = raster.bin_triangles(setup, width=width, height=height,
                                           tile_h=raster.TILE_H,
                                           tile_w=raster.TILE_W)
        trf, tri = raster.pack_setup_tables(setup)
        return setup, (counts, ids, trf, tri)

    def seg_tables(m, width, height, arr):
        """The setup table, and the segmented kernels' inputs: (ids,
        starts, counts, bb, bb_count) and (trf, tri, rec)."""
        setup = setup_of(m, width, height, arr)
        return (setup, raster.bin_segments(setup, width=width, height=height),
                tables_for("segmented", setup))

    def kernel_of(route, sampling):
        return f"raster_{route}_{sampling}"

    def binned_for(route, setup, width, height, y_offset=0):
        return tree_binned(raster, route, setup, width, height, y_offset)

    def tables_for(route, setup, gids=None):
        return tree_tables(raster, route, setup, gids)

    def gids_for(setup):
        s = setup["live"].shape[-1]
        return 2 * GID_BASE + torch.arange(s, dtype=torch.int32, device=dev)

    # ---- 3. kernels vs plain versions on the card ----
    phase("3. kernels vs plain versions")
    errs = {k: {} for k in FORMS}

    def report(store, key, res, what):
        store[key] = res
        print(f"{what}: {json.dumps(res)}", flush=True)

    def hold(name, key, inputs, tex, kw, what):
        """Kernel ``name`` against its plain version on the same inputs."""
        pk, dk = getattr(raster, name)(*inputs, tex, **kw)
        pp, dp = getattr(raster, f"{name}_plain")(*inputs, tex, **kw)
        what = f"{name} vs plain {what}"
        report(errs[name], key, compare(pk, dk, pp, dp, what), what)
        return pk, dk

    for sampling in ("nearest", "bilinear"):
        flat, seg = kernel_of("flat", sampling), kernel_of("segmented", sampling)
        for width, height in RESOLUTIONS:
            kw = dict(width=width, height=height, background=bg)
            tex = arrays["default"]["textures"]
            for pose in (0, FLIGHT_POSES - 1):
                setup, args = flat_tables(poses[pose], width, height,
                                          arrays["default"])
                pk, dk = hold(flat, (width, height, pose), args, tex, kw,
                              f"{width}x{height} pose {pose}")
                # The segmented kernel on the same table: the flat kernel's frame.
                binned = raster.bin_segments(setup, width=width, height=height)
                ps, ds = getattr(raster, seg)(*binned, *args[2:],
                                              raster.pack_slot_records(setup),
                                              tex, **kw)
                what = (f"{seg} vs {flat} default {width}x{height} pose {pose}")
                report(errs[seg], ("default", width, height, pose),
                       compare(ps, ds, pk, dk, what), what)

    # The other small scene families, flown into (near-plane splits), at a
    # frame width that leaves a ragged column of tiles; the textured ones
    # also with bilinear sampling.
    cam = Camera()
    into = [cam.update(Input(up=2.0), force_update=(i == 0)).copy()
            for i in range(6)]
    for name in ("tetrahedron", "icosahedron", "anisotropic", "clipping"):
        arr = scene_to_device(SCENES[name](seed=0), dev)
        kw = dict(width=RAGGED[0], height=RAGGED[1], background=bg)
        samplings = (("nearest", "bilinear") if name in ("icosahedron", "anisotropic")
                     else ("nearest",))
        for pose in (0, 5):
            _, args = flat_tables(into[pose], *RAGGED, arr)
            for sampling in samplings:
                hold(kernel_of("flat", sampling), (name, pose), args,
                     arr["textures"], kw,
                     f"{name} {RAGGED[0]}x{RAGGED[1]} pose {pose}")

    # The large scenes through the segmented kernels.
    seg_cases = [("stress840", w, h, pose, ("nearest", "bilinear"))
                 for w, h in RESOLUTIONS for pose in (0, FLIGHT_POSES - 1)]
    seg_cases += [("regular_floor", *RAGGED, 0, ("nearest",)),
                  ("stress100k", *RAGGED, 0, ("nearest",)),
                  ("stress100k", *RESOLUTIONS[0], 0, ("nearest", "bilinear"))]
    arrays["regular_floor"] = scene_to_device(SCENES["regular_floor"](seed=0), dev)
    for name, width, height, pose, samplings in seg_cases:
        _, binned, tables = seg_tables(poses[pose], width, height, arrays[name])
        kw = dict(width=width, height=height, background=bg)
        ntiles = raster.seg_lists(width, height)[0]
        for sampling in samplings:
            hold(kernel_of("segmented", sampling), (name, width, height, pose),
                 (*binned, *tables), arrays[name]["textures"], kw,
                 f"{name} {width}x{height} pose {pose} (S {tables[0].shape[1]}, "
                 f"entries {int(binned[2][:ntiles].sum())}, super-tile entries "
                 f"{int(binned[2][ntiles:].sum())}, residual broadband "
                 f"{int(binned[4][0])})")

    # The segmented kernels' lists at other K and G (G = 1 lists no slot by
    # super-tile), on a ragged frame and on a band at y0 > 0, untracked and
    # tracked, against their plain versions.
    for (width, height), y0, k, g in (
            (RAGGED, 0, raster.SEG_K, 1), (RAGGED, 0, raster.SEG_K, 4),
            (RAGGED, 0, raster.SEG_K, 16), (RAGGED, 0, 4, raster.SEG_G),
            (RESOLUTIONS[0], 270, raster.SEG_K, raster.SEG_G),
            (RESOLUTIONS[0], 270, 4, 2)):
        setup = setup_of(poses[0], width, height, arrays["stress840"])
        band = height - 2 * y0
        binned = raster.bin_segments(setup, width=width, height=band, k=k,
                                     g=g, y_offset=y0)
        kw = dict(width=width, height=band, background=bg, g=g, y_offset=y0)
        for sampling in ("nearest", "bilinear"):
            name = kernel_of("segmented", sampling)
            for track in (False, True):
                args = (*binned, *tables_for("segmented", setup,
                                             gids_for(setup) if track else None),
                        arrays["stress840"]["textures"])
                got = getattr(raster, name)(*args, track_ids=track, **kw)
                want = getattr(raster, f"{name}_plain")(*args, track_ids=track,
                                                        **kw)
                what = (f"{name} vs plain stress840 {width}x{band} at y0 {y0}, "
                        f"K {k}, G {g}{', tracked' if track else ''}")
                res = compare(*got[:2], *want[:2], what)
                check(not track or torch.equal(got[2], want[2]),
                      f"{what}: gid planes differ")
                report(errs[f"{name}_ids" if track else name],
                       ("lists", width, band, y0, k, g), res, what)

    # Each kernel's batched launch (B = 4: the flight's first four poses at
    # 1920x1080) against its plain version and against its launches frame
    # by frame.
    width, height = RESOLUTIONS[0]
    kw = dict(width=width, height=height, background=bg)
    for route, name in (("flat", "default"), ("segmented", "stress840")):
        tables = flat_tables if route == "flat" else seg_tables
        _, *args = tables(np.stack(poses[:4]), width, height, arrays[name])
        args = args[0] if route == "flat" else (*args[0], *args[1])
        tex = arrays[name]["textures"]
        for sampling in ("nearest", "bilinear"):
            kernel = kernel_of(route, sampling)
            pb, db = hold(kernel, (name, "B=4"), args, tex, kw,
                          f"{name} B=4 {width}x{height}")
            launch = getattr(raster, kernel)
            singles = [launch(*(t[b] for t in args), tex, **kw) for b in range(4)]
            what = f"{kernel} B=4 launch vs 4 single launches {name}"
            report(errs[kernel], (name, "B=4 vs singles"), compare(
                pb, db, torch.stack([p for p, _ in singles]),
                torch.stack([d for _, d in singles]), what), what)

    # Each kernel's tracking form (gids 2 * GID_BASE + slot) against its
    # plain version, pixels, depth and gids bit for bit, and its pixels and
    # depth against the kernel's own launch on the same inputs.
    def hold_ids(route, sampling, setup, width, height, tex, what):
        name = kernel_of(route, sampling)
        args = (*binned_for(route, setup, width, height),
                *tables_for(route, setup, gids_for(setup)), tex)
        kw = dict(width=width, height=height, background=bg)
        pk, dk, gk = getattr(raster, name)(*args, track_ids=True, **kw)
        pp, dp, gp = getattr(raster, f"{name}_plain")(*args, track_ids=True,
                                                      **kw)
        pn, dn = getattr(raster, name)(*args, **kw)
        what = f"{name} tracking vs plain {what}"
        res = compare(pk, dk, pp, dp, what)
        check(torch.equal(gk, gp), f"{what}: gid planes differ")
        compare(pk, dk, pn, dn, f"{what}: tracking vs untracked launch")
        drawn = dk > 0
        check(bool((gk[~drawn] == -1).all())
              and bool((gk[drawn] >= 2 * GID_BASE).all()),
              f"{what}: gids out of range")
        report(errs[f"{name}_ids"], what, {**res, "gid_equal": True,
                                           "tracking_equals_untracked": True},
               what)

    width, height = RESOLUTIONS[0]
    ids_cases = [("flat", s, "default", poses[0]) for s in ("nearest", "bilinear")]
    ids_cases += [("segmented", s, n, poses[0]) for n in ("stress840", "stress100k")
                  for s in ("nearest", "bilinear")]
    ids_cases += [("flat", "bilinear", "icosahedron", poses[0])]
    ids_cases += [(route, s, n, np.stack(poses[:4])) for route, n in (
        ("flat", "default"), ("segmented", "stress840"))
        for s in ("nearest", "bilinear")]
    for route, sampling, name, m in ids_cases:
        setup = setup_of(m, width, height, arrays[name])
        hold_ids(route, sampling, setup, width, height,
                 arrays[name]["textures"],
                 f"{name} {width}x{height} B={m.shape[0] if m.ndim == 3 else 1}")

    # Bands: each frame cut into 2, 4 and 8 bands (rows [y0, y1), y0 > 0 for
    # all but the first), each band binned and launched with y_offset = y0,
    # stitched: the full frame, bit for bit, for all four kernels.
    bands = []
    for route, name in (("flat", "default"), ("segmented", "stress840")):
        setup = setup_of(poses[0], width, height, arrays[name])
        tables = tables_for(route, setup)
        tex = arrays[name]["textures"]
        for sampling in ("nearest", "bilinear"):
            kernel = getattr(raster, kernel_of(route, sampling))
            full = kernel(*binned_for(route, setup, width, height), *tables,
                          tex, width=width, height=height, background=bg)
            for n in BANDS:
                edges = [height * i // n for i in range(n + 1)]
                parts = [kernel(*binned_for(route, setup, width, y1 - y0, y0),
                                *tables, tex, width=width, height=y1 - y0,
                                background=bg, y_offset=y0)
                         for y0, y1 in zip(edges, edges[1:])]
                what = (f"{kernel_of(route, sampling)} {name} {width}x{height}"
                        f" in {n} bands, stitched, vs the full frame")
                res = compare(torch.cat([p for p, _ in parts]),
                              torch.cat([d for _, d in parts]), *full, what)
                bands.append({"kernel": kernel_of(route, sampling),
                              "scene": name, "bands": n,
                              "bit_equal": res["bit_equal"]})
                print(f"{what}: {json.dumps(res)}", flush=True)

    # ---- 4. the main paths ----
    phase("4. main paths")
    launches = {k: 0 for k in FORMS}

    def counted(name, fn, want):
        """``fn()`` with every form's launch count set to 0 just before and
        read just after: it must equal ``want`` ({form: launches})."""
        reset_launches(raster)
        out = fn()
        torch.cuda.synchronize()
        got = read_launches(raster)
        print(f"main path {name}: launches {json.dumps(got)}", flush=True)
        check(got == {k: want.get(k, 0) for k in FORMS},
              f"{name}: launches {got}, want {want}")
        for k in FORMS:
            launches[k] += got[k]
        return out

    def drive(name, renderer, runs, want, batch=0, min_drawn=0.2):
        """Render ``runs`` ((width, height), poses): frame by frame, or in
        calls of ``batch`` poses through render_batch, with the four launch
        counts set to 0 just before; check the counts just after against
        ``want`` ({kernel: launches per call}), each frame, and (batches)
        each frame against its single-frame render."""
        reset_launches(raster)
        if batch:
            calls = [((w, h), ms[i:i + batch]) for (w, h), ms in runs
                     for i in range(0, len(ms), batch)]
            outs = [(size, renderer.render_batch(np.stack(ms), *size))
                    for size, ms in calls]
            frames = [(size, (p[b], d[b])) for size, (p, d) in outs
                      for b in range(p.shape[0])]
        else:
            calls = [((w, h), [m]) for (w, h), ms in runs for m in ms]
            frames = [(size, renderer.render_device(ms[0], *size))
                      for size, ms in calls]
        torch.cuda.synchronize()
        got = read_launches(raster)
        n = len(calls)
        print(f"main path {name}: {len(frames)} frames in {n} calls, "
              f"launches {json.dumps(got)}", flush=True)
        check(got == {k: want.get(k, 0) * n for k in FORMS},
              f"{name}: launches {got} for {n} calls, want {want} per call")
        for k in FORMS:
            launches[k] += got[k]
        for (w, h), (pix, depth) in frames:
            check(tuple(pix.shape) == (h, w) and pix.dtype == torch.int32,
                  f"{name}: pixels {tuple(pix.shape)} {pix.dtype} at {w}x{h}")
            check(bool(torch.isfinite(depth).all()), f"{name}: non-finite depth")
            check(bool((depth >= 0).all()), f"{name}: negative depth")
        for (w, h), ms in runs:
            pix = next(p for size, (p, _) in frames if size == (w, h))
            drawn = float((pix != bg).float().mean())
            print(f"  {name} {w}x{h} pose 0: {drawn:.3f} of pixels drawn")
            check(drawn > min_drawn,
                  f"only {drawn} of the frame drawn at {w}x{h}")
        if batch:
            singles = [renderer.render_device(m, w, h) for (w, h), ms in runs
                       for m in ms]
            for ((w, h), (p, d)), (ps, ds) in zip(frames, singles):
                compare(p, d, ps, ds, f"{name}: batch frame vs single frame")
            print(f"  {name}: {len(frames)} batch frames bit-equal to their "
                  f"single-frame renders", flush=True)

    renderers = {name: Renderer(scenes[name], device="cuda")
                 for name in ("default", "stress840", "stress100k", "tetrahedron")}
    renderers.update({f"{name} bilinear": Renderer(scenes[name], bilinear,
                                                   device="cuda")
                      for name in ("default", "stress840", "icosahedron")})
    fly = [(size, poses) for size in RESOLUTIONS]
    drive("default", renderers["default"], fly, {"raster_flat_nearest": 1})
    drive("stress840", renderers["stress840"], fly,
          {"raster_segmented_nearest": 1})
    drive("stress100k", renderers["stress100k"],
          [(RESOLUTIONS[0], poses[:POSES_100K])], {"raster_segmented_nearest": 1})
    drive("icosahedron bilinear", renderers["icosahedron bilinear"],
          [(RESOLUTIONS[0], poses)], {"raster_flat_bilinear": 1})
    drive("default bilinear", renderers["default bilinear"], fly,
          {"raster_flat_bilinear": 1})
    drive("stress840 bilinear", renderers["stress840 bilinear"],
          [(RESOLUTIONS[0], poses)], {"raster_segmented_bilinear": 1})
    drive("default B=4", renderers["default"], [(RESOLUTIONS[0], poses)],
          {"raster_flat_nearest": 1}, batch=4)
    # The one tetrahedron covers about a fifth of the frame.
    drive("tetrahedron B=8", renderers["tetrahedron"], [(CONFIG1, poses40)],
          {"raster_flat_nearest": 1}, batch=8, min_drawn=0.1)

    small_scenes = {"default": scenes["default"],
                    "stress128": SCENES["stress"](seed=0, objects=128)}
    for name, sc in small_scenes.items():
        for config in (cfg, bilinear):
            on_card = Renderer(sc, config, device="cuda")
            on_cpu = Renderer(sc, config, device="cpu")
            sizes = ((SMALL, RAGGED_SMALL) if name == "default"
                     and config is cfg else (SMALL,))
            picks = ((0, 10, FLIGHT_POSES - 1) if config is cfg
                     else (0, FLIGHT_POSES - 1))
            for width, height in sizes:
                for pose in picks:
                    pg, dg = on_card.render(poses[pose], width, height)
                    pc, dc = on_cpu.render(poses[pose], width, height)
                    what = (f"cuda vs cpu renderer {name} {config.sampling} "
                            f"{width}x{height} pose {pose}")
                    res = compare(pg, dg, pc, dc, what)
                    print(f"{what}: {json.dumps(res)}", flush=True)
            ms = np.stack(poses[:3])
            pg, dg = on_card.render_batch(ms, *SMALL)
            pc, dc = on_cpu.render_batch(ms, *SMALL)
            what = (f"cuda vs cpu render_batch {name} {config.sampling} "
                    f"B=3 {SMALL[0]}x{SMALL[1]}")
            print(f"{what}: {json.dumps(compare(pg, dg, pc, dc, what))}",
                  flush=True)

    # The multi-device paths. One card holds one NCCL rank: the NCCL group
    # here has one rank (render_scene_sharded, ShardedRenderer), and the
    # N-rank composites run as N per-range pipelines in turn, each the
    # device work of one rank, merged as the butterfly merges them.
    composites = {"default": (arrays["default"], cfg),
                  "stress840": (arrays["stress840"], cfg),
                  "stress100k": (arrays["stress100k"], cfg),
                  "icosahedron bilinear": (arrays["icosahedron"], bilinear),
                  "stress840 bilinear": (arrays["stress840"], bilinear)}

    def rank_range(name, n, r):
        """Rank r's (lo, count) of n, as render_scene_sharded cuts them."""
        local = -(-composites[name][0]["vert_c"].shape[0] // n)
        return r * local, local

    def composite(name, m, n, width, height):
        """The n-rank triangle-sharded frame on one card: (pix, 1/z, gid)."""
        arr, config = composites[name]
        acc = None
        for r in range(n):
            lo, count = rank_range(name, n, r)
            out = render_range(arr, m, lo=lo, count=count, width=width,
                               height=height, config=config)
            acc = out if acc is None else merge_depth_gid(*acc, *out)
        return acc

    width, height = RESOLUTIONS[0]
    m0 = torch.as_tensor(poses[0], device=dev)
    sharded = []
    for name, form in (("default", "raster_flat_nearest_ids"),
                       ("stress840", "raster_segmented_nearest_ids"),
                       ("stress100k", "raster_segmented_nearest_ids"),
                       ("icosahedron bilinear", "raster_flat_bilinear_ids"),
                       ("stress840 bilinear", "raster_segmented_bilinear_ids")):
        want_p, want_d = renderers[name].render_device(poses[0], width, height)
        for n in SCENE_RANKS:
            pix, depth, gid = counted(
                f"{name} {n}-rank composite {width}x{height}",
                lambda: composite(name, m0, n, width, height), {form: n})
            compare(pix, depth, want_p, want_d,
                    f"{name} {n}-rank composite vs single render")
            check(bool((gid[depth == 0] == raster.NO_GID).all()),
                  f"{name} {n}-rank composite: gid where nothing won")
            sharded.append({"scene": name, "ranks": n, "bit_equal": True})
        print(f"  {name}: the {SCENE_RANKS}-rank composites bit-equal to the "
              f"single render", flush=True)

    # render_batch_sharded's 2 x 4 grid as its eight rank blocks (frames
    # split in two, rows in four bands; a rank's block needs no collective).
    ms4 = torch.as_tensor(np.stack(poses[:4]), device=dev)
    for name, form in (("default", "raster_flat_nearest"),
                       ("stress840", "raster_segmented_nearest")):
        want_p, want_d = renderers[name].render_batch(np.stack(poses[:4]),
                                                      width, height)
        blocks = counted(
            f"{name} render_batch_sharded {GRID[0]}x{GRID[1]} grid blocks",
            lambda: [render_batch_sharded(
                arrays[name], ms4, width=width, height=height,
                mesh=Mesh(*GRID, r, dev, None, None, None))
                for r in range(GRID[0] * GRID[1])],
            {form: GRID[0] * GRID[1]})
        rows = [(torch.cat([p for p, _ in blocks[f * GRID[1]:(f + 1) * GRID[1]]],
                           dim=1),
                 torch.cat([d for _, d in blocks[f * GRID[1]:(f + 1) * GRID[1]]],
                           dim=1)) for f in range(GRID[0])]
        compare(torch.cat([p for p, _ in rows]), torch.cat([d for _, d in rows]),
                want_p, want_d, f"{name} render_batch_sharded grid vs render_batch")
        print(f"  {name}: the {GRID[0]}x{GRID[1]} grid's blocks stitch to "
              f"render_batch, bit for bit", flush=True)

    # A real NCCL process group of one rank (rank 0, an in-process store).
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, device="cuda")
        for name, form in (("default", "raster_flat_nearest_ids"),
                           ("stress840", "raster_segmented_nearest_ids")):
            pix, depth = counted(
                f"{name} render_scene_sharded, NCCL world of 1",
                lambda: render_scene_sharded(arrays[name], m0, width=width,
                                             height=height, mesh=mesh),
                {form: 1})
            compare(pix, depth, *renderers[name].render_device(
                poses[0], width, height),
                f"{name} render_scene_sharded (NCCL, 1 rank) vs render_device")
        sr = ShardedRenderer(scenes["default"], mesh=mesh, device="cuda")
        pix, depth = counted(
            "default ShardedRenderer.render_batch, NCCL 1 x 1 mesh",
            lambda: sr.render_batch(np.stack(poses[:4]), width, height),
            {"raster_flat_nearest": 1})
        compare(pix, depth, *renderers["default"].render_batch(
            np.stack(poses[:4]), width, height),
            "ShardedRenderer.render_batch (NCCL, 1 x 1) vs render_batch")
        print("  NCCL: render_scene_sharded and ShardedRenderer.render_batch "
              "bit-equal to the single-card renders", flush=True)
    finally:
        dist.destroy_process_group()

    # ---- 5. timings ----
    phase("5. timings")
    table = []

    def cell(name, renderer, size, ms, sampling="nearest", batch=0):
        return {"name": name, "renderer": renderer, "size": size, "ms": ms,
                "sampling": sampling, "batch": batch}

    cells = [cell("default", "default", size, poses) for size in RESOLUTIONS]
    cells += [cell("stress840", "stress840", size, poses) for size in RESOLUTIONS]
    cells += [cell("stress100k", "stress100k", RESOLUTIONS[0],
                   poses[:POSES_100K]),
              cell("icosahedron bilinear", "icosahedron bilinear",
                   RESOLUTIONS[0], poses, "bilinear")]
    cells += [cell("default bilinear", "default bilinear", size, poses,
                   "bilinear") for size in RESOLUTIONS]
    cells += [cell("stress840 bilinear", "stress840 bilinear", RESOLUTIONS[0],
                   poses, "bilinear"),
              cell("default B=4", "default", RESOLUTIONS[0], poses, batch=4),
              cell("tetrahedron B=8", "tetrahedron", CONFIG1, poses40, batch=8)]

    def calls_of(c):
        step = c["batch"] or 1
        return [c["ms"][i:i + step] for i in range(0, len(c["ms"]), step)]

    def render_call(renderer, ms, width, height, batch):
        if batch:
            return renderer.render_batch(np.stack(ms), width, height)
        return renderer.render_device(ms[0], width, height)

    def call_times(renderer, calls, width, height, batch):
        per_call = []
        for ms in calls:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render_call(renderer, ms, width, height, batch)
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end))
        return per_call

    def frame_times(renderer, ms, width, height):
        return call_times(renderer, [[m] for m in ms], width, height, 0)

    for c in cells:
        (width, height), b, sampling = c["size"], c["batch"], c["sampling"]
        renderer = renderers[c["renderer"]]
        arr = renderer.dev
        tex = arr["textures"]
        calls = calls_of(c)
        per_call = call_times(renderer, calls, width, height, b)
        first = np.stack(calls[0]) if b else calls[0][0]
        mt = torch.as_tensor(first, device=dev)
        kw = dict(width=width, height=height, background=bg)
        stage_ms = {"build_setup": time_ms(torch, lambda: build_setup(
            arr, mt, width=width, height=height, config=cfg), 20)}
        route = "flat" if 2 * arr["vert_c"].shape[0] <= raster.FLAT_MAX_SLOTS \
            else "segmented"
        kernel = kernel_of(route, sampling)
        frames = range(b) if b else [None]

        def frame_of(args, i):
            return args if i is None else tuple(t[i] for t in args)

        if route == "flat":
            setup, args = flat_tables(first, width, height, arr)
            stage_ms["bin_triangles"] = time_ms(torch, lambda: raster.bin_triangles(
                setup, width=width, height=height, tile_h=raster.TILE_H,
                tile_w=raster.TILE_W), 20)
            bounds = [flat_bound(raster, *frame_of(args, i), tex, width, height,
                                 sampling) for i in frames]
        else:
            setup, binned, tables = seg_tables(first, width, height, arr)
            stage_ms["bin_segments"] = time_ms(torch, lambda: raster.bin_segments(
                setup, width=width, height=height), 20)
            stage_ms["pack_slot_records"] = time_ms(
                torch, lambda: raster.pack_slot_records(setup), 20)
            args = (*binned, *tables)
            bounds = [segmented_bound(raster, frame_of(binned, i),
                                      *frame_of(tables, i), tex, width,
                                      height, sampling) for i in frames]
        stage_ms["pack_setup_tables"] = time_ms(
            torch, lambda: raster.pack_setup_tables(setup), 20)
        bound = bounds[0]
        if b:   # the batch's work is its frames' work
            bound = {**bound_of(sum(x["bytes"] for x in bounds),
                                sum(x["flops"] for x in bounds)),
                     "atlas_words_fetched": sum(x["atlas_words_fetched"]
                                                for x in bounds)}
        launch = getattr(raster, kernel)
        plain = getattr(raster, f"{kernel}_plain")
        row = {"scene": c["name"], "at": f"{width}x{height}", "kernel": kernel,
               "batch": b or 1, "slots": int(setup["live"].shape[-1]),
               "calls": len(calls),
               "frame_ms_median": statistics.median(per_call) / (b or 1),
               "frame_ms_min": min(per_call) / (b or 1),
               "frame_ms_max": max(per_call) / (b or 1),
               "call_ms_median": statistics.median(per_call),
               "stage_ms": stage_ms,
               "ms": time_cold_ms(torch, lambda: launch(*args, tex, **kw)),
               "plain_ms": time_ms(torch, lambda: plain(*args, tex, **kw), 2,
                                   warmup=1),
               **bound}
        table.append(row)
        print(f"timing {c['name']} {width}x{height}: {json.dumps(row)}",
              flush=True)

    # The segmented binner's K at the default G, and G at the default K:
    # tile entries, super-tile entries, the residual broadband list, the
    # sort, the binner and the kernel at pose 0 (the 32 x 8 tile is fixed
    # by the kernel; G = 1 lists no slot by super-tile, as the parent).
    seg_sweep = []
    for c in cells[2:5]:
        (width, height), arr = c["size"], renderers[c["renderer"]].dev
        setup = setup_of(c["ms"][0], width, height, arr)
        tables = tables_for("segmented", setup)
        for k, g in ([(k, raster.SEG_G) for k in SEG_K_SWEEP]
                     + [(raster.SEG_K, g) for g in SEG_G_SWEEP
                        if g != raster.SEG_G]):
            kw = dict(width=width, height=height, background=bg, g=g)
            keys, big = raster.segment_keys(setup, width=width, height=height,
                                            k=k, g=g)
            binned = raster.bin_segments(setup, width=width, height=height,
                                         k=k, g=g)
            ntiles = raster.seg_lists(width, height, g)[0]
            res = {"scene": c["name"], "at": f"{width}x{height}", "k": k,
                   "g": g, "entries": int(binned[2][:ntiles].sum()),
                   "super_tile_entries": int(binned[2][ntiles:].sum()),
                   "broadband_slots": int(binned[4][0]),
                   "sort_us": 1e3 * time_ms(
                       torch, lambda: torch.sort(keys, stable=True), 10,
                       windows=3),
                   "bin_segments_ms": time_ms(torch, lambda: raster.bin_segments(
                       setup, width=width, height=height, k=k, g=g), 10,
                       windows=3),
                   "kernel_ms_cold": time_cold_ms(
                       torch, lambda: raster.raster_segmented_nearest(
                           *binned, *tables, arr["textures"], **kw), reps=20)}
            seg_sweep.append(res)
            print(f"seg_k {c['name']} {width}x{height}: {json.dumps(res)}",
                  flush=True)

    # The default scene through either route, the segmented one forced by
    # lifting the flat route's slot limit: the two frames (bit-equal), the
    # flights interleaved flat, segmented, segmented, flat, and each route's
    # binner and kernel at pose 0.
    flat_max = raster.FLAT_MAX_SLOTS

    def on_route(route, fn):
        raster.FLAT_MAX_SLOTS = flat_max if route == "flat" else -1
        try:
            return fn()
        finally:
            raster.FLAT_MAX_SLOTS = flat_max

    arr, tex = arrays["default"], arrays["default"]["textures"]
    routes = {}
    for width, height in RESOLUTIONS:
        def route_flight(route):
            return on_route(route, lambda: frame_times(
                renderers["default"], poses, width, height))

        flat_f, seg_f = route_flight("flat"), route_flight("segmented")
        seg_f, flat_f = seg_f + route_flight("segmented"), flat_f + route_flight("flat")
        pf, df = on_route("flat", lambda: renderers["default"].render_device(
            poses[0], width, height))
        ps, ds = on_route("segmented", lambda: renderers[
            "default"].render_device(poses[0], width, height))
        compare(ps, ds, pf, df, f"default scene frame, segmented vs flat "
                                f"route {width}x{height}")
        setup, (counts, ids, trf, tri) = flat_tables(poses[0], width, height, arr)
        binned = raster.bin_segments(setup, width=width, height=height)
        kw = dict(width=width, height=height, background=bg)
        res = {"flat_frame_ms_median": statistics.median(flat_f),
               "segmented_frame_ms_median": statistics.median(seg_f),
               "bin_triangles_ms": time_ms(torch, lambda: raster.bin_triangles(
                   setup, width=width, height=height, tile_h=raster.TILE_H,
                   tile_w=raster.TILE_W), 20),
               "bin_segments_ms": time_ms(torch, lambda: raster.bin_segments(
                   setup, width=width, height=height), 20),
               "flat_kernel_ms": time_cold_ms(
                   torch, lambda: raster.raster_flat_nearest(
                       counts, ids, trf, tri, tex, **kw)),
               "segmented_kernel_ms": time_cold_ms(
                   torch, lambda: raster.raster_segmented_nearest(
                       *binned, trf, tri, raster.pack_slot_records(setup), tex,
                       **kw)),
               "entries": int(binned[2].sum()),
               "broadband_slots": int(binned[4][0])}
        routes[(width, height)] = res
        print(f"route default {width}x{height}: {json.dumps(res)}", flush=True)

    # The serving sweep: the default scene's flight, SWEEP_FRAMES frames per
    # setting, in calls of B poses through render_batch; ms per frame from
    # CUDA events around each call; the batched raster launch L2 cold.
    sweep = []
    for width, height in RESOLUTIONS:
        for b in BATCH_SWEEP:
            calls = [poses[i:i + b] for i in range(0, SWEEP_FRAMES, b)]
            per_call = call_times(renderers["default"], calls, width, height, b)
            _, args = flat_tables(np.stack(calls[0]), width, height, arr)
            kw = dict(width=width, height=height, background=bg)
            res = {"at": f"{width}x{height}", "batch": b, "calls": len(calls),
                   "call_ms_median": statistics.median(per_call),
                   "ms_per_frame": sum(per_call) / SWEEP_FRAMES,
                   "raster_kernel_ms_cold": time_cold_ms(
                       torch, lambda: raster.raster_flat_nearest(*args, tex, **kw
                                                                 ), reps=20)}
            sweep.append(res)
            print(f"batch sweep default {width}x{height} B={b}: "
                  f"{json.dumps(res)}", flush=True)

    # The tracking forms against their kernels, L2 cold, at each kernel's
    # main shape (pose 0, 1920x1080) in turns untracked, tracked, tracked,
    # untracked; the tracking plain versions; the bound is the kernel's plus
    # the gid plane's 4 bytes per pixel.
    width, height = RESOLUTIONS[0]
    main_shapes = (("default", "flat", "nearest"),
                   ("stress840", "segmented", "nearest"),
                   ("icosahedron bilinear", "flat", "bilinear"),
                   ("stress840 bilinear", "segmented", "bilinear"))
    ids_rows = {}
    for name, route, sampling in main_shapes:
        kernel = kernel_of(route, sampling)
        arr = composites[name][0]
        setup = setup_of(poses[0], width, height, arr)
        args = (*binned_for(route, setup, width, height),
                *tables_for(route, setup, gids_for(setup)), arr["textures"])
        kw = dict(width=width, height=height, background=bg)
        launch = getattr(raster, kernel)
        spans = {False: [], True: []}
        for track in (False, True, True, False):
            spans[track].append(time_cold_ms(
                torch, lambda: launch(*args, track_ids=track, **kw), reps=25))
        row = next(r for r in table if r["kernel"] == kernel
                   and r["scene"] == name and r["at"] == f"{width}x{height}")
        ids_rows[kernel] = {
            "scene": name, "at": f"{width}x{height}",
            "ms": statistics.median(spans[True]),
            "ms_untracked": statistics.median(spans[False]),
            "plain_ms": time_ms(torch, lambda: getattr(
                raster, f"{kernel}_plain")(*args, track_ids=True, **kw), 2,
                warmup=1),
            **bound_of(row["bytes"] + 4 * width * height, row["flops"])}
        print(f"timing {kernel} tracking {name} {width}x{height}: "
              f"{json.dumps(ids_rows[kernel])}", flush=True)

    # The per-range pipeline (render_range: one rank's device work in an
    # N-card triangle-sharded frame) for each rank at N = 1, 2, 4, 8, and
    # merge_depth_gid, at 1920x1080.
    range_ms = []
    for name in ("default", "stress840", "stress100k"):
        arr, config = composites[name]
        for n in RANGE_RANKS:
            per_rank = []
            for r in range(n):
                lo, count = rank_range(name, n, r)
                per_rank.append(time_ms(torch, lambda: render_range(
                    arr, m0, lo=lo, count=count, width=width, height=height,
                    config=config), 5, warmup=2, windows=3))
            res = {"scene": name, "at": f"{width}x{height}", "ranks": n,
                   "rank_ms": per_rank, "max_rank_ms": max(per_rank),
                   "mean_rank_ms": statistics.mean(per_rank)}
            range_ms.append(res)
            print(f"per-range pipeline: {json.dumps(res)}", flush=True)
    halves = [render_range(arrays["stress840"], m0, lo=lo, count=count,
                           width=width, height=height)
              for lo, count in (rank_range("stress840", 2, r) for r in range(2))]
    merge_ms = time_ms(torch, lambda: merge_depth_gid(*halves[0], *halves[1]),
                       20)
    print(f"merge_depth_gid {width}x{height}: {merge_ms} ms", flush=True)

    # With --parent DIR: the four kernels and their tracking forms at y0 = 0
    # against the parent tree's, each tree's kernel on its own binner's and
    # packer's outputs for the same setup table, L2 cold, in turns parent,
    # this, this, parent (the same card in one call): the flat kernels at
    # their 1080p main shapes, the segmented ones at the split's cells, and
    # stress 840 at 4K with this tree's G = 1: every wide slot then lies on
    # the residual broadband list, as in a scene whose wide slots each
    # cover more than K super-tiles.
    ab, frame_ab = [], []
    trees = {"this": raster}
    if parent:
        trees["parent"] = load_parent_raster(parent)
        ab_cases = [("default", "flat", "nearest", *RESOLUTIONS[0], None),
                    ("icosahedron bilinear", "flat", "bilinear",
                     *RESOLUTIONS[0], None)]
        ab_cases += [(name if sampling == "nearest" else f"{name} bilinear",
                      "segmented", sampling, w, h, g)
                     for name, w, h, g in [(*c, None) for c in SPLIT_CELLS]
                     + [("stress840", *RESOLUTIONS[1], 1)]
                     for sampling in ("nearest", "bilinear")]
        for name, route, sampling, w, h, g in ab_cases:
            kernel = kernel_of(route, sampling)
            arr = composites.get(name, (arrays[name.split()[0]],))[0]
            setup = setup_of(poses[0], w, h, arr)
            kw = dict(width=w, height=h, background=bg)
            this_kw = {} if g is None else {"g": g}
            for track in (False, True):
                gids = gids_for(setup) if track else None
                args = {who: (*tree_binned(r, route, setup, w, h,
                                           **(this_kw if who == "this" else {})),
                              *tree_tables(r, route, setup, gids),
                              arr["textures"]) for who, r in trees.items()}
                fns = {"parent": getattr(trees["parent"], kernel),
                       "this": functools.partial(getattr(raster, kernel),
                                                 **this_kw)}
                got = {who: fns[who](*args[who], track_ids=track, **kw)
                       for who in trees}
                compare(*got["this"][:2], *got["parent"][:2],
                        f"{kernel} {name} {w}x{h}: this tree vs the parent's")
                check(not track or torch.equal(got["this"][2], got["parent"][2]),
                      f"{kernel} {name}: gid planes differ from the parent's")
                spans = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent"):
                    spans[who].append(time_cold_ms(
                        torch, lambda: fns[who](*args[who], track_ids=track,
                                                **kw), reps=50))
                res = {"kernel": kernel + ("_ids" if track else ""),
                       "scene": name, "at": f"{w}x{h}", "this_g": g,
                       "parent_ms": statistics.median(spans["parent"]),
                       "this_ms": statistics.median(spans["this"]),
                       "spans": spans}
                res["ratio"] = res["this_ms"] / res["parent_ms"]
                ab.append(res)
                print(f"A/B vs parent: {json.dumps(res)}", flush=True)

        # The whole frame against the parent tree's Renderer on the same
        # scene, the flight in turns parent, this, this, parent; the default
        # scene (the flat route, the same code in both trees) shows what the
        # host's noise alone moves. And the segmented front-end's stages:
        # the parent's bin_segments against this tree's with
        # pack_slot_records, in the same turns.
        import importlib
        parent_renderer = importlib.import_module("s3d_parent.renderer").Renderer
        for name, (w, h) in (("default", RESOLUTIONS[0]),
                             ("stress840", RESOLUTIONS[0]),
                             ("stress840", RESOLUTIONS[1])):
            pair = {"parent": parent_renderer(scenes[name], device="cuda"),
                    "this": renderers[name]}
            setup = setup_of(poses[0], w, h, arrays[name])
            front = {"parent": lambda: trees["parent"].bin_segments(
                         setup, width=w, height=h),
                     "this": lambda: (raster.bin_segments(
                         setup, width=w, height=h),
                         raster.pack_slot_records(setup))}
            spans = {who: [] for who in pair}
            stages = {who: [] for who in pair}
            for who in ("parent", "this", "this", "parent"):
                spans[who] += frame_times(pair[who], poses, w, h)
                stages[who].append(time_ms(torch, front[who], 20))
            res = {"scene": name, "at": f"{w}x{h}",
                   **{f"{who}_frame_ms_median": statistics.median(spans[who])
                      for who in pair},
                   "parent_bin_segments_ms": statistics.median(stages["parent"]),
                   "this_bin_segments_and_records_ms": statistics.median(
                       stages["this"])}
            res["frame_ratio"] = (res["this_frame_ms_median"]
                                  / res["parent_frame_ms_median"])
            frame_ab.append(res)
            print(f"frame A/B vs parent: {json.dumps(res)}", flush=True)

    # The phase split of the segmented kernels (this tree, and the parent's
    # in turns with it when given).
    split_setups = {(name, w, h): setup_of(poses[0], w, h, arrays[name])
                    for name, w, h in SPLIT_CELLS}
    split_textures = {name: arrays[name]["textures"]
                      for name, _, _ in SPLIT_CELLS}
    split = segmented_split(torch, trees, split_setups, split_textures, bg)

    # ---- 6. device busy share of the flights, last: profiling leaves
    # host-side overhead behind it that would inflate the timings ----
    phase("6. profiles")
    for row, c in zip(table, cells):
        (width, height), b = c["size"], c["batch"]
        renderer, calls = renderers[c["renderer"]], calls_of(c)
        prof = device_busy(torch, lambda: [
            render_call(renderer, ms, width, height, b) for ms in calls])
        nframes = len(c["ms"])
        row["device_busy_share"] = prof["busy"]
        row["device_kernels_per_frame"] = prof["launched"] / nframes
        row["device_kernels_per_call"] = prof["launched"] / len(calls)
        row["d2h_copies"] = prof["d2h"]
        row["scalar_reads"] = prof["scalar_reads"]
        in_flight = sum(us for k, us in prof["per_kernel"].items()
                        if TRACE_NAMES[row["kernel"]] in k)
        row["ms_in_flight"] = (in_flight / nframes / 1e3 if in_flight
                               else "not measured")
        by_class = {}   # names cut to 60 characters group template instances
        for k, us in prof["per_kernel"].items():
            by_class[k[:60]] = by_class.get(k[:60], 0.0) + us
        top = dict(sorted(by_class.items(), key=lambda kv: kv[1],
                          reverse=True)[:6])
        print(f"profile {c['name']} {width}x{height}: device busy share "
              f"{prof['busy']}, {row['device_kernels_per_frame']} kernels per "
              f"frame ({row['device_kernels_per_call']} per call), "
              f"{row['kernel']} {row['ms_in_flight']} ms per frame, "
              f"device-to-host copies {prof['d2h']}, scalar reads "
              f"{prof['scalar_reads']}, top kernels (us over {nframes} frames) "
              f"{json.dumps(top)}", flush=True)
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"{c['name']} {width}x{height}: the flight copied to the host "
              f"({prof['d2h']} copies, {prof['scalar_reads']} scalar reads)")

    for res in sweep:
        width, height = map(int, res["at"].split("x"))
        b = res["batch"]
        calls = [poses[i:i + b] for i in range(0, SWEEP_FRAMES, b)]
        prof = device_busy(torch, lambda: [render_call(
            renderers["default"], ms, width, height, b) for ms in calls])
        res["device_busy_share"] = prof["busy"]
        res["kernels_per_call"] = prof["launched"] / len(calls)
        res["device_us_per_frame"] = sum(prof["per_kernel"].values()) / SWEEP_FRAMES
        res["raster_us_per_frame"] = sum(
            us for k, us in prof["per_kernel"].items()
            if TRACE_NAMES["raster_flat_nearest"] in k) / SWEEP_FRAMES
        print(f"batch sweep profile default {res['at']} B={b}: {json.dumps(res)}",
              flush=True)
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"batch sweep {res['at']} B={b}: copied to the host")

    for (width, height), res in routes.items():
        for route in ("flat", "segmented"):
            prof = on_route(route, lambda: device_busy(torch, lambda: [
                renderers["default"].render_device(m, width, height)
                for m in poses]))
            res[f"{route}_device_us_per_frame"] = (
                sum(prof["per_kernel"].values()) / len(poses))
            res[f"{route}_kernels_per_frame"] = prof["launched"] / len(poses)
            check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
                  f"default {width}x{height} {route} route: the flight copied "
                  f"to the host")
        print(f"route profile default {width}x{height}: {json.dumps(res)}",
              flush=True)

    # The 8-rank composites (per-range pipelines and merges): no copy to the
    # host; the card's time per rank and each tracking kernel's per launch
    # there.
    width, height = RESOLUTIONS[0]
    for name, route in (("default", "flat"), ("stress840", "segmented")):
        n = SCENE_RANKS[-1]
        prof = device_busy(torch, lambda: composite(name, m0, n, width, height))
        kernel = kernel_of(route, "nearest")
        us = sum(v for k, v in prof["per_kernel"].items()
                 if TRACE_NAMES[f"{kernel}_ids"] in k)
        ids_rows[kernel]["ms_in_8_rank_composite"] = (
            us / n / 1e3 if us else "not measured")
        device_ms = sum(prof["per_kernel"].values()) / n / 1e3
        print(f"profile {name} {n}-rank composite {width}x{height}: device busy "
              f"share {prof['busy']}, {prof['launched'] / n} kernels and "
              f"{device_ms} ms of device time per rank, {kernel}_ids "
              f"{ids_rows[kernel]['ms_in_8_rank_composite']} ms per launch, "
              f"device-to-host copies {prof['d2h']}, scalar reads "
              f"{prof['scalar_reads']}", flush=True)
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"{name} {n}-rank composite: copied to the host")

    def kernel_row(name, replaces, main_scene):
        rows_k = [r for r in table if r["kernel"] == name]
        main_at = "{} {}x{}".format(main_scene, *RESOLUTIONS[0])
        main = next(r for r in rows_k if f"{r['scene']} {r['at']}" == main_at)
        e = list(errs[name].values())
        return {
            "name": name,
            "route": "cuda",
            "source": "swift3drenderer_tpu_torch/csrc/raster.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(x["max_channel_err"] for x in e),
            "depth_max_abs_err": max(x["depth_max_abs_err"] for x in e),
            "pixel_mismatch": max(x["pixel_mismatch"] for x in e),
            "frames_compared": len(e),
            "tolerance": "bit-equal (checked); bounds pixel mismatch < "
                         f"{MISMATCH_BOUND} at tol 1, depth rtol {DEPTH_RTOL}",
            "at": main_at,
            "ms": main["ms"],
            "ms_in_flight": main["ms_in_flight"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "parent_ms_same_call": next((x["parent_ms"] for x in ab
                                         if x["kernel"] == name), "not measured"),
            "shapes": [{k: r.get(k) for k in (
                "scene", "at", "batch", "ms", "ms_in_flight", "plain_ms",
                "bound_ms", "bound_by", "tile_bound_ms", "frame_ms_median",
                "device_busy_share", "device_kernels_per_frame",
                "device_kernels_per_call", "entries", "super_tile_entries",
                "broadband_slots")}
                for r in rows_k],
        }

    def ids_row(kernel, replaces):
        r = ids_rows[kernel]
        e = list(errs[f"{kernel}_ids"].values())
        return {
            "name": f"{kernel}_ids",
            "route": "cuda",
            "source": "swift3drenderer_tpu_torch/csrc/raster.cu",
            "replaces": replaces,
            "launches": launches[f"{kernel}_ids"],
            "max_abs_err": max(x["max_channel_err"] for x in e),
            "depth_max_abs_err": max(x["depth_max_abs_err"] for x in e),
            "pixel_mismatch": max(x["pixel_mismatch"] for x in e),
            "frames_compared": len(e),
            "tolerance": "bit-equal pixels, depth and gids (checked); bounds "
                         f"pixel mismatch < {MISMATCH_BOUND} at tol 1, depth "
                         f"rtol {DEPTH_RTOL}",
            "at": f"{r['scene']} {r['at']}",
            "ms": r["ms"],
            "ms_untracked_same_call": r["ms_untracked"],
            "ms_in_8_rank_composite": r.get("ms_in_8_rank_composite",
                                            "not measured"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "parent_ms_same_call": next((x["parent_ms"] for x in ab
                                         if x["kernel"] == f"{kernel}_ids"),
                                        "not measured"),
        }

    phase("7. probes")
    probe_rows = probes_phase(torch)

    ids_source = "swift3drenderer_tpu/ops/raster_pallas.py:398"
    kernels_line = [
        kernel_row("raster_flat_nearest",
                   "swift3drenderer_tpu/ops/raster_pallas.py:249", "default"),
        kernel_row("raster_segmented_nearest",
                   "swift3drenderer_tpu/ops/raster_pallas.py:430", "stress840"),
        kernel_row("raster_flat_bilinear",
                   "swift3drenderer_tpu/ops/raster_pallas.py:618",
                   "icosahedron bilinear"),
        kernel_row("raster_segmented_bilinear",
                   "swift3drenderer_tpu/ops/raster_pallas.py:1132",
                   "stress840 bilinear"),
    ] + [ids_row(k, ids_source) for k in KERNELS] + probe_rows
    print(json.dumps({"bands": bands, "composites": sharded,
                      "per_range_ms": range_ms, "merge_ms": merge_ms,
                      "ab_parent": ab or "not measured",
                      "frame_ab_parent": frame_ab or "not measured",
                      "split": split,
                      "seg_sweep": seg_sweep}))
    phase("done")
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"] and len(args) == 2:
        parent = args[1]
    elif args:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    try:
        result = run(parent)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
