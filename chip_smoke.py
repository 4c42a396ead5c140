#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swift3drenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR]

Phases; any failed check raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (nvcc, sm_90a; one nvcc for each of
     raster.cu, frontend.cu and probes.cu, and for each measurement build of raster.cu,
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
     all four kernels; the segmented kernels' lists at other K and G
     (G = 1, 4, 16; K = 4) on a ragged frame and on a band, untracked and
     tracked; and the flat kernels' edges in all eight forms (tiles whose
     listed slots are all culled, depth ties at S = 125, a batch at a ragged
     size, a band on a ragged width, hundreds of listed slots a block); and
     each kernel's timing forms (phases "vis": the winning slot and its 1/z;
     "shade": no texel fetch) untracked and tracked, bit for bit against
     their plain versions (the flat kernels on the default scene, the
     segmented ones on stress 840, 1920x1080), their depth equal to the
     full form's;
  4. drive the main paths through Renderer(..., device="cuda"), which
     captures each frame size and batch in a CUDA graph at its first call
     and replays it, each with the launch counts of all four kernels and of
     the front-end kernel (one a graph) set to 0 just before and read just
     after (a wrapper counts the warm-up launch
     and the captured one of each new graph; replays launch without it, and
     the renderer counts them): the default scene and the 840-object stress field over bench.py's
     20-pose flight at both sizes, stress100k over its first 5 poses at
     1920x1080; with bilinear sampling the icosahedron scene (config 2) and
     stress 840 at 1920x1080 and the default scene at both sizes; and the
     serving path, Renderer.render_batch, on the default scene (B = 4,
     1920x1080, the flight in 5 calls) and the tetrahedron (B = 8, 640x480,
     config 1), every batch frame bit-equal to its single-frame render; then
     hold the card's output against the plain CPU path on small frames (one
     of them ragged), single frames and batches, nearest and bilinear; then
     the multi-device paths: the N-rank composites run as N per-range
     pipelines (renderer.render_range, each the device work of one rank)
     merged with merge_depth_gid, N = 2, 4, 8, on the default scene, stress
     840 and stress100k at 1920x1080 and, bilinear, the icosahedron and
     stress 840; render_batch_sharded's 2 x 4 grid as its eight rank
     blocks, eager and then through ShardedRenderer's graph of each rank
     (captured, replayed): each bit-equal to the single-card render; every
     rank's range of the N = 2, 4, 8 meshes of the default scene, stress
     840 and stress100k replayed from render_scene_sharded's graph cache
     (one capture, then replays at a new pose and the first), bit-equal to
     its eager render_range, the ranges merged equal to the single render;
     on an NCCL group of one rank (one card holds one NCCL rank; the group
     lives to the end of the run) render_scene_sharded on the same three
     scenes, three calls each (one capture, then replays), each bit-equal
     to render_device and to its eager range, the first call's result kept
     after the third; ShardedRenderer.render_batch on the 1 x 1 mesh, its
     rank's block captured at the first call and replayed at the next two,
     each call bit-equal to the eager block and to render_batch;
     ShardedRenderer(backend="xla") (default, B = 4, 640x480) captured and
     replayed, bit-equal to Renderer(backend="xla").render_batch; and the
     multi-chip hook, entry.dryrun_multichip on every card (its ranks are
     spawned processes that report their launches);
  5. time, with CUDA events after a warm-up: each cell's eager frame (or
     batch call: render_frames launched op by op), the front-end stages, its kernel (with the L2 cache cold, as a
     frame finds it) and plain version, beside the least time the card could
     take for the same work; the segmented binner's tile and super-tile
     entries, residual broadband slots, sort, binner and kernel times for
     several K at the default G and several G at the default K; the phase
     split of the segmented kernels (each launch with its broadband lists,
     its segments or both emptied) on stress 840 at both sizes and
     stress100k at 1920x1080; the phase split of the flat kernels (every
     list emptied, every slot untextured) and the floor of writing their
     output planes, on the default scene (both samplings, both sizes, B =
     4) and the icosahedron; the default scene through either route
     (flat, or segmented with the flat route's slot limit lifted): frames
     (bit-equal), binners and kernels; and the batch sweep B = 1, 2, 4, 8 at
     both sizes: ms per frame, kernels per call and the card's busy share;
     each tracking form against its kernel with the L2 cold, the per-range
     pipeline at N = 1, 2, 4, 8 (the device work of one rank of an N-card
     deployment) and merge_depth_gid; with --parent DIR (a checkout of the
     parent commit), the four kernels and their tracking forms against the
     parent tree's (the flat ones at both sizes, B = 4 and a band; the
     segmented ones at the split's cells and at 3840x2160 at G = 1, every
     wide slot residual), the splits of both trees, L2 cold,
     and each tree's whole frame (default, stress 840 at both sizes) and
     segmented binning, in turns parent, this, this, parent; and the
     frame's eight instances of csrc/raster.cu (phases 0) against the
     parent's: the same registers and spills in each build's ptxas report
     (no spills) and the same SASS (cuobjdump -sass, labels renumbered);
  6. the share of each eager flight's wall time the card is busy, each
     kernel's device time per frame in the flight, and the device-to-host
     copies the flight makes (must be none), from torch.profiler; each
     route's device time per frame of the default scene's flight; and the
     same copy check over the 8-rank composites (per-range pipelines and
     merges).
  7. the probes (swift3drenderer_tpu_torch.tools, csrc/probes.cu): each
     probe's main(device="cuda") with its launch count set to 0 just before
     and read just after (every mode checked against the tool's oracle and
     timed at the tool's full ITERS); every mode's kernel against its plain
     version on the card, bit for bit, at 1, 3, 64, 130 iterations and the
     full ITERS (probe_gather2d, probe_packed_fetch and fetch_microbench,
     whose iterations run in chunks, also at 0 and across their chunk
     length, the packed fetch at mix 0 and 127, each call one launch), and
     the dynamic grid at nc = 0-4 with nc in device memory; torch.profiler
     gives the dynamic grid's device time a launch at nc = 0-4 (nc = 0, no
     copy, is its fixed cost) and shows its calls make no device-to-host
     copy or scalar read; `cuobjdump -sass` counts each instance's global
     and shared loads inside its loops; each mode of the chunked probes
     fails if its time falls under its bound or its main loop holds fewer
     loads than an iteration's times the iterations it covers (global loads
     through L1, shared loads in the staged gather and the staged packed
     fetch: work dropped), and its printed line gives the floors of its L1
     and shared-memory wavefronts and warp loads at one an SM a cycle
     (worked out, not measured, so kept out of the kernels line); with
     --parent DIR each of their modes is timed against the parent tree's,
     and the dynamic grid's device time at each nc profiled against the
     parent's, in turns parent, this, this, parent (nc = 4 must be faster);
  8. the captured frames (run after phase 5, before the profiles of phase
     6, which would inflate its host times): every phase 5 cell's replayed
     flight bit-equal to its eager flight (both routes and samplings,
     single frames and batches); bucketed frames (Renderer.render(...,
     bucketed=True)) bit-equal to eager exact-size frames, the default
     scene at tests/test_resize.py's sizes, 1366x768 and 1920x1080 and
     stress 840 at 1366x768; the 50-step drag sweep 300x200 -> 790x445 in
     at most 4 captures, each step bit-equal, and its per-step time; after
     update_scene, replays bit-equal to a fresh renderer's eager frames on
     the moved scene; results held across calls still right; then, in
     turns eager, captured, captured, eager over each cell's flight: frame
     ms (median, min, max), host µs per replay call, ms per frame back to
     back; the copy out of the graph's outputs; capture ms and memory
     reserved per key; the default scene captured through either route;
     ShardedRenderer.render_batch (default, B = 4, 1920x1080, NCCL world
     of one) eager against replayed, in the same turns; render_scene_sharded
     (default, stress 840, stress100k at 1920x1080, NCCL world of one):
     the eager sharded frame, the replayed one and the captured frame, bit
     for bit and then in turns, with the n1 overheads and each key's
     capture ms and reserved MiB; and from torch.profiler each captured
     flight's, each replayed sharded flight's and stress100k's eight
     replayed ranges' busy share, kernels per replayed frame and
     device-to-host copies and scalar reads (must be none);
  9. the app and the tooling (run after phase 8, before phase 6): the
     headless flight (run_headless, default scene, 1920x1080, 120 frames
     of "60:w;60:w mx2", PPMs every 30 frames) through the flat kernel's
     one graph (2 launches, 120 replays, the cuda backend), its step times and
     % of the 1/60 s budget, the final frame bit-equal to the CPU's and
     within 0.2 % of golden; app.main on stress at 1366x768, on a data.bin
     datagen.main wrote and on an OBJ; compare_backends.main at 640x480
     (both backends within golden's bound, both samplings); entry(); the
     viewer on 127.0.0.1 at a port the OS picks (input events and a resize
     sweep over HTTP, one graph per bucket, the JPEG half where PIL
     imports); the "xla" backend (default scene at both sizes and
     samplings, captured and eager; stress 840 at 640x480 eager with 512-
     and 1024-slot chunks) bit-equal to the CPU and within the bound of the
     "cuda" backend; steady_state_frame_time beside the back-to-back
     captured flight. Each path's launches are counted from 0 and added to
     the kernels line;
 10. the validation matrix (run after phase 9, before phase 11):
     swift3drenderer_tpu_torch.tools.validate.main(["--fuzz", "12"]), the
     counterpart of tools/tpu_validate.py, 22 cases and 12 fuzz draws at
     the TPU tool's sizes, each card frame within golden's bound (0.2 %
     nearest, 0.3 % bilinear at tol 1) and bit-equal to the CPU's frame,
     the paths the TPU tool compared bit-equal; a FAIL line fails the run.
     Its launches are counted from 0 and added to the kernels line.
 11. the stage probes and the native core (run after phase 10, before
     phase 6): tools.perf_probe (default scene, 1920x1080 and 3840x2160)
     and tools.stress_probe (stress 840, 1920x1080) over a 10-pose flight,
     each stage a captured graph, with every launch count set to 0 just
     before and read just after (each timing form launched by its graphs'
     warm-ups and captures); each probe cell's full stage replayed at two
     poses, bit-equal to Renderer.render_device; each timing form L2 cold
     beside the full form, its plain version and its bound (the kernels
     line's timing rows); the native C++ core built on that machine, the
     default scene at 1920x1080 through Renderer(backend="native") within
     golden's 0.2 %, its host ms beside the card's captured frame, and
     tools.native_baseline at --frames-scale 1.
 12. the front-end kernel (run after phase 11, before phase 6):
     ops.frontend.frontend_setup against its plain version on the card,
     bit for bit and one launch a call, on the default scene and stress 840
     at 1920x1080 (one frame) and 3840x2160 (B = 4); then both timed with
     the L2 cache cold (a 2 GiB flush, which outlasts the wrapper's host
     work) beside the least time of the bytes the kernel must move (the
     corner arrays and matrices in, 48 words and two bytes a slot out, at
     3.35 TB/s): the kernels line's frontend_setup rows, each with the
     front-end's launches on the main paths of phases 4, 9 and 10.

The line before the last is one JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
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
# The front-end kernel (ops.frontend.frontend_setup, one launch a
# build_setup on the card), counted beside the raster forms.
FRONTEND = "frontend_setup"
COUNTED = FORMS + (FRONTEND,)
# Each form's name in a profiler trace (the template instance it launches:
# <sampling, tracking, phases>, phases 0 the frame).
TRACE_NAMES = {f"raster_{route}_{sampling}{ids}":
               f"raster_{route}_kernel<{str(sampling == 'bilinear').lower()}, "
               f"{str(bool(ids)).lower()}, 0>"
               for route in ("flat", "segmented")
               for sampling in ("nearest", "bilinear") for ids in ("", "_ids")}
# The timing forms of each route's kernels (phases "vis" and "shade", the
# TPU kernel's timing instrument): one instance each, whatever the sampling
# (they stop before the texel fetch), counted in each wrapper's
# .launches_vis and .launches_shade; and the TPU kernel's line where each
# stops.
TIMING_FORMS = {"raster_flat_vis": "swift3drenderer_tpu/ops/raster_pallas.py:514",
                "raster_flat_shade": "swift3drenderer_tpu/ops/raster_pallas.py:800",
                "raster_segmented_vis":
                    "swift3drenderer_tpu/ops/raster_pallas.py:491",
                "raster_segmented_shade":
                    "swift3drenderer_tpu/ops/raster_pallas.py:800"}
# Phase 11: the stage probes' cells and flight, and the native core's.
PROBE_FRAMES = 10
NATIVE_BASELINE_SCALE = 1
GID_BASE = 500             # tracking checks: gids 2 * GID_BASE + slot
SCENE_RANKS = (2, 4, 8)    # the emulated triangle-sharded composites
RANGE_RANKS = (1, 2, 4, 8)
BANDS = (2, 4, 8)
GRID = (2, 4)              # render_batch_sharded's (frame, fb) grid
# The triangle-sharded frames replayed from render_scene_sharded's graph
# cache, with the tracked form each rank's range launches.
SCENE_SHARDED = (("default", "raster_flat_nearest_ids"),
                 ("stress840", "raster_segmented_nearest_ids"),
                 ("stress100k", "raster_segmented_nearest_ids"))
XLA_BATCH_SIZE = (640, 480)   # ShardedRenderer(backend="xla")'s B = 4 batch
VALIDATE_FUZZ = 12         # phase 10: the TPU tool's fuzz draws 0-11
# The forms phase 10's cases launch: no case renders a scene past the flat
# route's slot limit with bilinear sampling, or tracks winners bilinear.
VALIDATE_FORMS = ("raster_flat_nearest", "raster_flat_bilinear",
                  "raster_segmented_nearest", "raster_flat_nearest_ids",
                  "raster_segmented_nearest_ids")

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
    from swift3drenderer_tpu_torch.ops import frontend
    for k in KERNELS:
        for counter in ("launches", "launches_ids", "launches_vis",
                        "launches_shade"):
            setattr(getattr(raster, k), counter, 0)
    frontend.frontend_setup.launches = 0


def read_launches(raster) -> dict:
    """Each of COUNTED's launch counts: a raster kernel's wrapper counts its
    plain launches in .launches and its tracking ones in .launches_ids; the
    front-end's wrapper counts in .launches."""
    from swift3drenderer_tpu_torch.ops import frontend
    out = {k: getattr(raster, k).launches for k in KERNELS}
    out.update({f"{k}_ids": getattr(raster, k).launches_ids for k in KERNELS})
    out[FRONTEND] = frontend.frontend_setup.launches
    return out


def read_timing_launches(raster) -> dict:
    """Each timing form's launch count, over both samplings' wrappers."""
    return {f"raster_{route}_{phases}": sum(
        getattr(getattr(raster, f"raster_{route}_{s}"), f"launches_{phases}")
        for s in ("nearest", "bilinear"))
        for route in ("flat", "segmented") for phases in ("vis", "shade")}


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
    launched, each kernel's device time (µs summed over the window, by name,
    and each launch's µs under ``durations``), and the device-to-host copies
    and scalar reads (``_local_scalar_dense``) the host made. ``busy`` is
    "not measured" if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel, durations = {}, {}
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
            durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        elif e.name in ("aten::_local_scalar_dense", "aten::item"):
            scalar_reads += 1
    total = sum(per_kernel.values())
    return {"busy": total / wall_us if total > 0 else "not measured",
            "launched": launched, "per_kernel": per_kernel,
            "durations": durations, "d2h": d2h,
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
               textures, width, height, list_bytes, sampling,
               phases="full") -> dict:
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
    whose bbox touches the tile. The timing forms need less: ``"vis"`` only
    each slot's 16 visibility words and no shading, ``"shade"`` no atlas
    word."""
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
    covered = int((win >= 0).sum().item()) if phases != "vis" else 0
    texels = (int(raster.fetched_texels(best, win, trf, tri, textures.shape[0],
                                        sampling).numel())
              if phases == "full" else 0)
    words = raster.REC_WORDS if phases == "vis" else TABLE_WORDS
    nbytes = (list_bytes + ids_read * 4 + slots.numel() * words * 4
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
               sampling, phases="full") -> dict:
    """work_bound of a flat kernel (in the form ``phases``) on one frame:
    each tile's list is its binned slots."""
    c = counts.reshape(-1).to("cpu").numpy().astype(np.int64)
    best, win = raster.visibility_plain(counts, ids, trf, tri, width=width,
                                        height=height)
    binned = ids.new_tensor(raster._binned_slots(counts, ids))
    return work_bound(raster, c, int(c.sum()), binned, best, win, trf, tri,
                      textures, width, height, c.size * 4, sampling, phases)


def segmented_bound(raster, binned, trf, tri, rec, textures, width, height,
                    sampling, phases="full") -> dict:
    """work_bound of a segmented kernel (in the form ``phases``) on one
    frame: a tile's slots are
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
                     height, counts.numel() * 8 + 4, sampling, phases)
    return {**out, "entries": entries, "super_tile_entries": super_entries,
            "broadband_slots": wide}


def load_parent(parent: str, name: str = "ops.raster"):
    """Module ``name`` (by default ``ops.raster``) of the port in another
    checkout (the parent commit's), imported as package ``s3d_parent``: its
    kernels build from its own csrc/ into its own _build/."""
    import importlib
    import importlib.util
    import os

    if "s3d_parent" not in sys.modules:
        pkg = os.path.join(os.path.abspath(parent), "swift3drenderer_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            "s3d_parent", os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        module = importlib.util.module_from_spec(spec)
        sys.modules["s3d_parent"] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"s3d_parent.{name}")


# The phase split of the segmented kernels: stress 840 at both sizes and
# stress100k at 1080p, each launch timed L2 cold with some of its lists
# emptied (measurement inputs only; the emptied launches' outputs are thrown
# away). "broadband" is every list a tile filters by bbox (the super-tile
# segments and the residual list), "residual" the frame-wide list alone,
# "segments" the tiles' own segments.
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


# The phase split of the flat kernels, the same definition as the segmented
# one: each launch timed L2 cold at pose 0 in full, with every tile's list
# emptied ("no_lists": counts 0, the block's fixed cost and the background
# stores) and with every slot untextured ("untextured": row _ISTEX 0, the
# texel fetch gone); and the floor, the card's time to write the same output
# planes with one fill_ each. Cells (scene, sampling, width, height, B).
FLAT_SPLIT_CELLS = (("default", "nearest", 1920, 1080, 1),
                    ("default", "nearest", 3840, 2160, 1),
                    ("default", "bilinear", 1920, 1080, 1),
                    ("default", "bilinear", 3840, 2160, 1),
                    ("icosahedron", "bilinear", 1920, 1080, 1),
                    ("default", "nearest", 1920, 1080, 4))
FLAT_SPLIT_WAYS = ("full", "no_lists", "untextured")


def flat_ways(raster, counts, ids, trf, tri) -> dict:
    """The flat kernels' inputs (counts, ids, trf, tri) for each way of
    FLAT_SPLIT_WAYS."""
    untextured = tri.clone()
    untextured[..., raster._ISTEX, :] = 0
    return {"full": (counts, ids, trf, tri),
            "no_lists": (counts.new_zeros(counts.shape), ids, trf, tri),
            "untextured": (counts, ids, trf, untextured)}


def flat_split(torch, trees: dict, setups: dict, textures: dict, bg: int,
               reps: int = 30) -> list:
    """Phase split of the flat kernels of each tree ({"parent": its
    ops.raster, "this": ours}) on the same setup tables (``setups``: {cell of
    FLAT_SPLIT_CELLS: setup}), untracked and tracked: each way timed L2 cold
    in turns parent, this, this, parent (this alone without a parent), and
    the floor (fill_ of the output planes) once per turn. Share = 1 − ms
    with that part emptied / full ms."""
    order = (["parent", "this", "this", "parent"] if "parent" in trees
             else ["this"])
    out = []
    for cell, setup in setups.items():
        scene, sampling, width, height, b = cell
        kw = dict(width=width, height=height, background=bg)
        lead = (b,) if b > 1 else ()
        for track in (False, True):
            args = {}
            for who, r in trees.items():
                ids, counts = r.bin_triangles(setup, width=width,
                                              height=height, tile_h=r.TILE_H,
                                              tile_w=r.TILE_W)
                gids = None
                if track:
                    s = setup["live"].shape[-1]
                    gids = torch.arange(s, dtype=torch.int32,
                                        device=counts.device)
                trf, tri = r.pack_setup_tables(setup, gids)
                args[who] = flat_ways(r, counts, ids, trf, tri)
            planes = [torch.empty((*lead, height, width), dtype=dt,
                                  device=setup["live"].device)
                      for dt in (torch.int32, torch.float32,
                                 torch.int32)[:2 + track]]

            def floor():
                for p in planes:
                    p.fill_(bg if p.dtype == torch.int32 else 0)

            spans = {(who, way): [] for who in trees
                     for way in FLAT_SPLIT_WAYS + ("floor",)}
            for who in order:
                launch = getattr(trees[who], f"raster_flat_{sampling}")
                for way in FLAT_SPLIT_WAYS:
                    spans[who, way].append(time_cold_ms(
                        torch, lambda: launch(*args[who][way],
                                              textures[scene],
                                              track_ids=track, **kw),
                        reps=reps))
                spans[who, "floor"].append(time_cold_ms(torch, floor,
                                                        reps=reps))
            for who in trees:
                ms = {way: statistics.median(spans[who, way])
                      for way in FLAT_SPLIT_WAYS + ("floor",)}
                res = {"tree": who, "scene": scene, "sampling": sampling,
                       "at": f"{width}x{height}", "batch": b,
                       "tracked": track, "ms": ms,
                       "lists_share": 1 - ms["no_lists"] / ms["full"],
                       "texel_share": 1 - ms["untextured"] / ms["full"],
                       "floor_share": ms["floor"] / ms["full"]}
                out.append(res)
                print(f"flat split: {json.dumps(res)}", flush=True)
    return out


PROBE_ITERS = (1, 3, 64, 130)   # small counts, beside each tool's full ITERS
PROBE_MIXES = (0, 127)
PROBE_CHUNKS = (0, 1, 2, 3, 4)
DYNAMIC_CALLS = 50
# The probes whose iterations run in chunks on the whole card.
CHUNKED = ("probe_gather2d", "probe_packed_fetch", "fetch_microbench")
PROBE_AB_REPS = 5
CHUNK_KEYS = ("this_ms_ab", "parent_ms", "speedup_vs_parent")
PROBE_FAMILIES = {"probe_gather2d": ("probe_gather2d_kernel",
                                     "probe_gather2d_staged_kernel"),
                  "probe_packed_fetch": ("probe_packed_fetch_kernel",
                                         "probe_packed_fetch_staged_kernel"),
                  "fetch_microbench": ("fetch_microbench_kernel",),
                  "probe_dynamic_grid": ("probe_dynamic_grid_kernel",)}


def sass_loops(path: str) -> dict:
    """From ``cuobjdump -sass`` of a built library, for each kernel (by its
    mangled name): the instructions inside its loops (from a backward
    branch's target to the branch), the global loads (LDG) among them, its
    global loads in all, and the most global and shared (LDS) loads any one
    loop holds. {"error": ...} if cuobjdump is missing or fails."""
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
        loops = []
        for i, (_, text) in enumerate(instrs):
            branch = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", text)
            if not branch:
                continue
            target = branch.group(1)
            j = (labels.get(target) if target.startswith(".L")
                 else at.get(int(target, 16)))
            if j is not None and j <= i:
                loops.append(range(j, i + 1))
        in_loop = set().union(*loops)
        loads = {kind: [i for i, (_, text) in enumerate(instrs)
                        if opcode(text).startswith(kind)]
                 for kind in ("LDG", "LDS")}
        out[name] = {"loop_instructions": len(in_loop),
                     "global_loads_in_loops": sum(i in in_loop
                                                  for i in loads["LDG"]),
                     "global_loads": len(loads["LDG"]),
                     "most_global_loads_a_loop": max(
                         (sum(i in r for i in loads["LDG"]) for r in loops),
                         default=0),
                     "most_shared_loads_a_loop": max(
                         (sum(i in r for i in loads["LDS"]) for r in loops),
                         default=0)}
    return out


def raster_instance(name: str):
    """(route, bilinear, tracking, phases) of a raster kernel instance's
    mangled name, phases 0 (the frame) where the instance has no such
    argument (a tree from before the timing forms), or None."""
    import re
    m = re.search(r"raster_(flat|segmented)_kernelILb([01])ELb([01])E"
                  r"(?:Li(\d+)E)?E", name)
    return None if m is None else (m.group(1), m.group(2) == "1",
                                   m.group(3) == "1", int(m.group(4) or 0))


def ptxas_usage(log: str) -> dict:
    """From nvcc's ``-Xptxas -v`` output: each raster kernel instance's
    registers and spill bytes (stores + loads), by ``raster_instance``."""
    import re
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            key = raster_instance(m.group(1))
            if key is not None:
                out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[key]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def raster_sass(path: str) -> dict:
    """From ``cuobjdump -sass`` of a built raster library: each kernel
    instance's instructions (by ``raster_instance``), addresses dropped and
    branch labels renamed in their order within the instance, so that two
    builds of the same code compare equal. {"error": ...} if cuobjdump
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
    out = {}
    for chunk in proc.stdout.split("Function : ")[1:]:
        key = raster_instance(chunk.split(None, 1)[0])
        if key is None:
            continue
        labels, instrs = {}, []
        for line in chunk.splitlines():
            ins = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
            if ins:
                instrs.append(re.sub(
                    r"\.L_x_\d+",
                    lambda l: labels.setdefault(l.group(0), f"L{len(labels)}"),
                    ins.group(1)))
        out[key] = instrs
    return out


def same_as_parent(this_log: str, parent_log: str, this_so: str,
                   parent_so: str) -> list:
    """The frame's instances (phases 0) of this tree's raster kernels against
    the parent tree's: registers and spills from each build's ptxas report,
    and the SASS, instruction for instruction. Fails where any differs, or
    where one spills. Returns one row an instance."""
    ours, theirs = ptxas_usage(this_log), ptxas_usage(parent_log)
    sass = {"this": raster_sass(this_so), "parent": raster_sass(parent_so)}
    for who, got in sass.items():
        check("error" not in got, f"SASS of the {who} tree: {got.get('error')}")
    rows = []
    for key in sorted(k for k in ours if k[3] == 0):
        check(key in theirs and key in sass["parent"] and key in sass["this"],
              f"instance {key}: missing from a build of either tree")
        row = {"instance": "raster_{}_kernel<{}, {}, 0>".format(
                   key[0], str(key[1]).lower(), str(key[2]).lower()),
               **{f"this_{k}": v for k, v in ours[key].items()},
               **{f"parent_{k}": v for k, v in theirs[key].items()},
               "sass_instructions": len(sass["this"][key]),
               "sass_equal": sass["this"][key] == sass["parent"][key]}
        rows.append(row)
        print(f"full form vs parent: {json.dumps(row)}", flush=True)
        check(ours[key] == theirs[key] and ours[key].get("spill_bytes") == 0,
              f"{row['instance']}: registers or spills differ from the "
              f"parent's, or it spills ({json.dumps(row)})")
        check(row["sass_equal"], f"{row['instance']}: SASS differs from the "
              "parent's")
    check(len(rows) == 8, f"{len(rows)} full-form instances, want 8")
    return rows


def probe_sass(sass: dict, probe: str, mode_index: int | None) -> dict:
    """The sass_loops entry of one probe kernel instance (its template
    argument is the mode's index) with its mangled name under "kernel", or
    "not measured"."""
    import re
    for name, entry in sass.items():
        if not any(family in name for family in PROBE_FAMILIES[probe]):
            continue
        arg = re.search(r"ILi(\d+)E", name)
        if mode_index is None or (arg and int(arg.group(1)) == mode_index):
            return {"kernel": name, **entry}
    return {"error": sass.get("error", "not measured: instance not found")}


def quartiles_us(values: list) -> list:
    """The lower and upper quartiles of ``values``, or [] for fewer than
    two."""
    if len(values) < 2:
        return []
    q = statistics.quantiles(values, n=4)
    return [q[0], q[2]]


def max_sm_clock_hz():
    """The card's highest SM clock (``nvidia-smi``), or None if unread."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(smi.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        return None


def chunked_checks(entry: dict, name: str, module, mode: str, args: tuple,
                   ab: dict, sms: int, clock_hz) -> dict:
    """Check one mode of a chunked probe and add its A/B against the parent
    tree's. Its time may not fall under its bound, nor the main loop of its
    kernel hold fewer loads than an iteration's times the iterations it
    covers: UNROLL iterations through L1 (global loads) or from the packed
    fetch's block in shared memory (shared loads), or, in the staged
    gather, STAGED_PIXELS pixels a thread times a stage's iterations from
    shared memory; either would mean work was dropped. Returns the mode's
    floors, worked out from its inputs and not measured (for the printed
    line only): at the highest SM clock and one wavefront an SM a cycle, an
    iteration's L1 wavefronts (a 128-byte line a warp's load touches), for
    probe_gather2d and probe_packed_fetch its shared-memory wavefronts (a
    warp's load's bank conflicts, if staged), and its warp-wide loads (L1's
    and shared memory's 128 bytes a cycle). The packed fetch's lanes shift
    with it & mix, so its counts are the mean over the shifts the call
    visits."""
    from swift3drenderer_tpu_torch.tools import _probe

    atlas, ln, iters = args[1], args[3], args[-1]
    if name == "probe_gather2d":
        patterns = [module.load_words(mode, args[2], ln)]
    elif name == "probe_packed_fetch":
        mix = args[4]
        shifts = {it & mix for it in range(min(iters, 1 << mix.bit_length()))}
        patterns = [module.load_words(mode, ln, d) for d in sorted(shifts)]
    else:
        patterns = [module.load_words(mode, ln)]
    loads = len(patterns[0])

    def per_iter(count):
        return sum(sum(map(count, words)) for words in patterns) / len(patterns)

    cycles_ms = iters / (sms * clock_hz) * 1e3 if clock_hz else None
    counts = {"l1": per_iter(_probe.distinct_lines)}
    if name != "fetch_microbench":   # whose modes may stage their blocks
        counts["smem"] = per_iter(_probe.bank_wavefronts)
    floors = {}
    for key, count in counts.items():
        floors[f"{key}_wavefronts_per_iter"] = count
        floors[f"{key}_wavefront_ms"] = (count * cycles_ms if cycles_ms
                                         else "not measured")
    floors["load_issue_ms"] = (loads * ln.numel() // 32 * cycles_ms
                               if cycles_ms else "not measured")
    sass = entry["sass"]
    check("error" not in sass, f"{name} {mode}: no SASS ({sass})")
    staged = "staged" in sass["kernel"]
    if staged and name == "probe_gather2d":   # a ring of several blocks
        group = module.STAGE_BYTES // (atlas.numel() * 4 // module.NBLK)
        need, kind = loads * module.STAGED_PIXELS * group, "shared"
    else:   # fold_chunk's steps, from L1 or the packed fetch's one block
        need, kind = loads * _probe.UNROLL, "shared" if staged else "global"
    check(sass[f"most_{kind}_loads_a_loop"] >= need,
          f"{name} {mode}: its main loop holds fewer than {need} {kind} "
          f"loads, {loads} an iteration times the iterations it covers "
          f"({sass})")
    times = [entry["ms"]]
    if (name, mode) in ab:
        entry["this_ms_ab"] = ab[name, mode]["this"]
        entry["parent_ms"] = ab[name, mode]["parent"]
        entry["speedup_vs_parent"] = entry["parent_ms"] / entry["this_ms_ab"]
        times.append(entry["this_ms_ab"])
    check(min(times) >= entry["bound_ms"],
          f"{name} {mode}: {min(times)} ms is under its bound "
          f"{entry['bound_ms']} ms")
    return floors


def probes_phase(torch, parent: str | None = None) -> list:
    """Phase 7: the probes' entry points, their kernels against the plain
    versions, the dynamic grid's copy check, the chunked probes' checks that
    no work was dropped and their A/B against the parent tree's, and one
    kernels-line row each."""
    from swift3drenderer_tpu_torch import kernels
    from swift3drenderer_tpu_torch.tools import (
        _probe, fetch_microbench, probe_dynamic_grid, probe_gather2d,
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
    # The probes whose iterations run in chunks on the whole card: also no
    # iteration, and one chunk and two (the last of one iteration) at the
    # chunk length of small counts.
    for name in CHUNKED:
        counts_of[name] = (0,) + counts_of[name] + (_probe.MIN_CHUNK,
                                                    _probe.MIN_CHUNK + 1)
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
            before = wrappers[name].launches
            got, want = wrappers[name](*args), plains[name](*args)
            check(name not in CHUNKED or wrappers[name].launches == before + 1,
                  f"{name} {args[0]} at {args[-1]} iterations: "
                  f"{wrappers[name].launches - before} launches, not 1")
            err = (got.double() - want.double()).abs().max().item()
            what = [a if isinstance(a, (str, int)) else tuple(a.shape) for a in args]
            check(torch.equal(got, want), f"{name} {what}: kernel and plain "
                  f"version differ (max abs err {err})")
            errs[name] = max(errs[name], err)
        print(f"probe {name}: kernel == plain version, bit for bit, in "
              f"{len(args_list)} calls", flush=True)

    # The dynamic grid's launch is a few microseconds, shorter than the
    # wrapper's host work, so its device time comes from the profiler's
    # trace of DYNAMIC_CALLS back-to-back calls at each count, nc = 0 (no
    # copy: the launch's fixed cost) included: the median of the launches'
    # durations (late in a long run the trace kept 78-89 of 100 launches'
    # events, so a sum over the window undercounts). The trace also shows
    # the calls copy nothing to the host.
    # With a parent tree, each count in turns parent, this, this, parent.
    grids = {"this": probe_dynamic_grid.probe_dynamic_grid}
    if parent:
        grids["parent"] = load_parent(
            parent, "tools.probe_dynamic_grid").probe_dynamic_grid

    def grid_launch_us(who, args, n):
        prof = device_busy(torch, lambda: [grids[who](*args)
                                           for _ in range(DYNAMIC_CALLS)])
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"probe_dynamic_grid ({who}) nc={n}: the calls copied to the "
              f"host ({prof['d2h']} copies, {prof['scalar_reads']} scalar "
              "reads)")
        return [us for k, v in prof["durations"].items()
                if PROBE_FAMILIES["probe_dynamic_grid"][0] in k for us in v]

    device_ms, grid_ab = {}, {}
    for n in PROBE_CHUNKS:
        args = (tab, hbm, count(n))
        turns = ("parent", "this", "this", "parent") if parent else ("this",)
        spans = {who: [] for who in grids}
        for who in turns:
            spans[who] += grid_launch_us(who, args, n)
        med = {who: statistics.median(v) / 1e3 if v else "not measured"
               for who, v in spans.items()}
        device_ms[n] = med["this"]
        if parent:
            grid_ab[n] = med
        print(f"profile probe_dynamic_grid nc={n}: {device_ms[n]} ms of device "
              f"time per launch (median of {len(spans['this'])} launches, "
              f"quartiles {quartiles_us(spans['this'])} µs), no "
              "device-to-host copy or scalar read"
              + (f"; A/B vs parent {json.dumps(grid_ab[n])}, the parent's "
                 f"quartiles {quartiles_us(spans['parent'])} µs"
                 if parent else ""), flush=True)
    if parent:
        nc = probe_dynamic_grid.NCMAX
        check(all(isinstance(v, float) for v in grid_ab[nc].values())
              and grid_ab[nc]["this"] < grid_ab[nc]["parent"],
              f"probe_dynamic_grid nc={nc}: device time {grid_ab[nc]} is not "
              "below the parent's")

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
    # The chunked probes against the parent tree's, each mode at the tool's
    # full count, in turns parent, this, this, parent.
    ab = {}
    if parent:
        for name in CHUNKED:
            trees = {"this": wrappers[name],
                     "parent": getattr(load_parent(parent, f"tools.{name}"),
                                       name)}
            for mode, args in full[name].items():
                spans = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent"):
                    spans[who].append(time_ms(
                        torch, lambda: trees[who](*args), reps=PROBE_AB_REPS,
                        warmup=1, windows=1))
                ab[name, mode] = {who: statistics.median(v)
                                  for who, v in spans.items()}
                print(f"probe A/B vs parent: {name} {mode} "
                      f"{json.dumps(ab[name, mode])}", flush=True)

    clock_hz = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"probes: {sms} SMs, highest SM clock {clock_hz} Hz", flush=True)
    rows, floors = [], {}
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
            if name in CHUNKED:
                floors[name, mode] = chunked_checks(entry, name, module, mode,
                                                    args, ab, sms, clock_hz)
            if name == "probe_dynamic_grid" and mode in grid_ab:
                entry["this_ms_ab"] = grid_ab[mode]["this"]
                entry["parent_ms"] = grid_ab[mode]["parent"]
                if all(isinstance(v, float) for v in grid_ab[mode].values()):
                    entry["speedup_vs_parent"] = (entry["parent_ms"]
                                                  / entry["this_ms_ab"])
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
        if name in CHUNKED or name == "probe_dynamic_grid":
            rows[-1]["parent_ms_same_call"] = main.get("parent_ms",
                                                       "not measured")
        if name == "probe_dynamic_grid":   # nc = 0: the launch, no copy
            rows[-1]["fixed_cost_ms"] = device_ms[0]
            if 0 in grid_ab:
                rows[-1]["parent_fixed_cost_ms"] = grid_ab[0]["parent"]
            print(f"probe probe_dynamic_grid: fixed cost (nc = 0, no copy) "
                  f"{device_ms[0]} ms of device time a launch, bound at nc = "
                  f"{probe_dynamic_grid.NCMAX} {main['bound_ms']} ms", flush=True)
        for e in modes:
            print(f"probe {name} {e['mode']}: {e['ms']} ms, ns/iter "
                  f"{e.get('ns_per_iter', '-')} (net "
                  f"{e.get('net_ns_per_iter', '-')}), plain {e['plain_ms']} ms, "
                  f"bound {e['bound_ms']} ms ({e['bound_by']}), launches "
                  f"{e['launches']}, sass {json.dumps(e['sass'])}"
                  + "".join(f", {k} {e[k]}" for k in CHUNK_KEYS if k in e)
                  + (f", floors worked out, not measured "
                     f"{json.dumps(floors[name, e['mode']])}"
                     if (name, e["mode"]) in floors else ""),
                  flush=True)
    return rows


# ---- 9. the app and the tooling (the app shell, its CLIs, the viewer, the
# "xla" backend and the profiling helper), on the card ----
APP_SIZE = (1920, 1080)
APP_FRAMES = 120
APP_SCRIPT = "60:w;60:w mx2"     # the app CLI's default flight
APP_OUT_EVERY = 30
CLI_SIZE = (1366, 768)
CLI_FRAMES = 30
COMPARE_SIZE = (640, 480)
GOLDEN_BOUND = {"nearest": 0.002, "bilinear": 0.003}
VIEWER_START = (640, 360)
VIEWER_SIZES = ((700, 400), (900, 500), (1280, 720), (1300, 740))
XLA_POSE = 10                    # the flight's pose for the xla cells
XLA_STRESS_CHUNKS = (512, 1024)  # results depend on no chunk: both held
XLA_STRESS_BAND = (200, 16)      # the CPU's rows of the stress frame
CUBE_OBJ = """o cube
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 5 1 4 8
"""


def bounded(pix_a, depth_a, pix_b, depth_b, what: str) -> dict:
    """Hold a frame against another backend's: the same drawn set, pixel
    mismatch < MISMATCH_BOUND at tol 1, depth rtol DEPTH_RTOL."""
    pa, pb = (p.cpu().numpy().view(np.uint32) for p in (pix_a, pix_b))
    da, db = depth_a.cpu().numpy(), depth_b.cpu().numpy()
    mis = pixel_mismatch_fraction(pa, pb)
    both = (da > 0) & (db > 0)
    rel = float(np.max(np.abs(da[both] - db[both]) / db[both])) if both.any() else 0.0
    out = {"pixel_mismatch": mis, "max_channel_err": max_channel_err(pa, pb),
           "depth_max_rel_err": rel,
           "coverage_differs": int(((da > 0) != (db > 0)).sum())}
    check(mis < MISMATCH_BOUND and rel <= DEPTH_RTOL
          and out["coverage_differs"] == 0, f"{what}: {json.dumps(out)}")
    return out


def event_ms(torch, fn, reps: int) -> list:
    """Device ms of each of ``reps`` synchronised calls of ``fn``."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def app_phase(torch, scenes, poses, renderers, captured, launches) -> dict:
    """Phase 9: the app shell's headless flight, the CLIs, the viewer, the
    "xla" backend and ``steady_state_frame_time``, each main path with the
    launch counts set to 0 just before and read just after (added to
    ``launches``)."""
    import contextlib
    import io
    import os
    import tempfile
    import threading
    import urllib.request

    from swift3drenderer_tpu_torch import app, datagen
    from swift3drenderer_tpu_torch.config import RenderConfig
    from swift3drenderer_tpu_torch.entry import entry
    from swift3drenderer_tpu_torch.examples import compare_backends
    from swift3drenderer_tpu_torch.golden import render_frame as golden_render
    from swift3drenderer_tpu_torch.ops import raster, raster_xla
    from swift3drenderer_tpu_torch.renderer import (
        Renderer, bucket_dims, build_setup, render_frame_xla, render_frames,
        scene_to_device)
    from swift3drenderer_tpu_torch.utils.profiling import steady_state_frame_time
    from swift3drenderer_tpu_torch.utils.telemetry import FrameStats
    from swift3drenderer_tpu_torch.viewer import ViewerServer

    summary = {"optional_packages": {}}
    for mod in ("PIL", "matplotlib", "sklearn"):
        try:
            summary["optional_packages"][mod] = __import__(mod).__version__
        except ImportError as exc:
            summary["optional_packages"][mod] = f"absent ({exc})"
    print(f"app optional packages (the viewer's JPEG, the photo textures): "
          f"{json.dumps(summary['optional_packages'])}", flush=True)

    def counted(name, fn, want):
        """``fn()`` with every form's count set to 0 just before and read
        just after: it must equal ``want`` (2 per graph captured: its
        warm-up and its capture)."""
        reset_launches(raster)
        out = fn()
        torch.cuda.synchronize()
        got = read_launches(raster)
        print(f"app path {name}: launches {json.dumps(got)}", flush=True)
        check(got == {k: want.get(k, 0) for k in COUNTED},
              f"{name}: launches {got}, want {want}")
        for k in COUNTED:
            launches[k] += got[k]
        return out

    def spread(xs):
        return {"median": statistics.median(xs), "min": min(xs),
                "max": max(xs)}

    # (a) The headless flight: run_headless on the default scene at 1080p,
    # 120 frames of the CLI's default script, PPMs every 30 frames.
    class FrameTimes(FrameStats):
        """Telemetry reporting every frame, keeping each frame's seconds."""

        def __init__(self):
            super().__init__(report_interval=0.0, printer=None)
            self.seconds = []

        def add_frame(self, render_seconds, **stages):
            self.seconds.append(render_seconds)
            super().add_frame(render_seconds, **stages)

    loops = []

    class WatchedLoop(app.FrameLoop):
        """The app's FrameLoop, kept for its renderer's counts and its
        camera after run_headless returns."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            loops.append(self)

    width, height = APP_SIZE
    scene = scenes["default"]
    stats = FrameTimes()
    app.FrameLoop = WatchedLoop
    try:
        with tempfile.TemporaryDirectory() as tmp:
            pix, _ = counted("headless flight", lambda: app.run_headless(
                scene, width=width, height=height, frames=APP_FRAMES,
                script=APP_SCRIPT, out_dir=tmp, out_every=APP_OUT_EVERY,
                stats=stats, device="cuda"),
                {"raster_flat_nearest": 2, FRONTEND: 2})
            ppms = sorted(os.listdir(tmp))
    finally:
        app.FrameLoop = WatchedLoop.__base__
    (loop,) = loops
    graphs = loop.renderer.graphs
    check(graphs.captures == 1 and graphs.replays == APP_FRAMES,
          f"headless flight: {graphs.captures} captures, {graphs.replays} "
          f"replays for {APP_FRAMES} frames")
    check(loop.renderer.backend == "cuda",
          f"headless flight rendered on {loop.renderer.backend!r}")
    check(len(ppms) == APP_FRAMES // APP_OUT_EVERY, f"PPMs written: {ppms}")
    m = loop.camera.matrix
    cpu_pix, _ = Renderer(scene, device="cpu").render(m, width, height)
    check(np.array_equal(pix, cpu_pix),
          "headless flight: the final frame differs from the CPU's")
    gp, _ = golden_render(scene, m, width, height)
    frame_ms = [1e3 * s for s in stats.seconds]
    summary["headless"] = {
        "at": f"{width}x{height}", "frames": APP_FRAMES,
        "frame_ms": spread(frame_ms),
        "budget_percent": stats.reports[-1]["average"],
        "captures": graphs.captures, "replays": graphs.replays,
        "backend": loop.renderer.backend, "ppms": len(ppms),
        "final_vs_cpu": "bit-equal",
        "final_vs_golden": pixel_mismatch_fraction(pix, gp)}
    print(f"app headless flight: {json.dumps(summary['headless'])}", flush=True)
    check(summary["headless"]["final_vs_golden"] < GOLDEN_BOUND["nearest"],
          "headless flight: the final frame is past golden's bound")

    # (b) The CLIs: app.main on stress, on a data.bin datagen wrote, on an
    # OBJ; compare_backends; the entry hook.
    clis = {}
    size = ["--width", str(CLI_SIZE[0]), "--height", str(CLI_SIZE[1]),
            "--frames", str(CLI_FRAMES), "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data.bin")
        check(datagen.main(["--scene", "default", "--seed", "0",
                            "--out", data]) == 0, "datagen.main failed")
        obj = os.path.join(tmp, "cube.obj")
        with open(obj, "w") as f:
            f.write(CUBE_OBJ)
        for name, scene_arg, kernel in (
                ("stress", "stress", "raster_segmented_nearest"),
                ("data.bin", data, "raster_flat_nearest"),
                ("obj", obj, "raster_flat_nearest")):
            out = os.path.join(tmp, f"frames_{name}")
            t0 = time.perf_counter()
            rc = counted(f"app.main {name}", lambda: app.main(
                ["--scene", scene_arg, "--out", out] + size),
                {kernel: 2, FRONTEND: 2})
            clis[f"app.main {name}"] = {
                "rc": rc, "s": time.perf_counter() - t0,
                "final_ppm": os.path.exists(os.path.join(out, "final.ppm"))}
            check(rc == 0 and clis[f"app.main {name}"]["final_ppm"],
                  f"app.main {name}: {clis[f'app.main {name}']}")
    for sampling, kernel in (("nearest", "raster_flat_nearest"),
                             ("bilinear", "raster_flat_bilinear")):
        text = io.StringIO()

        def compare_main():
            with contextlib.redirect_stdout(text):
                return compare_backends.main(
                    ["default", "{}x{}".format(*COMPARE_SIZE), "--device",
                     "cuda", "--sampling", sampling])

        # One graph captured on each device backend ("cuda" and "xla");
        # the front-end runs in both, the raster kernel in the first.
        rc = counted(f"compare_backends {sampling}", compare_main,
                     {kernel: 2, FRONTEND: 4})
        lines = text.getvalue().splitlines()
        for line in lines:
            print(f"  {line}")
        clis[f"compare_backends {sampling}"] = {"rc": rc, "lines": lines}
        check(rc == 0, f"compare_backends {sampling}: a backend is past "
              f"golden's {GOLDEN_BOUND[sampling]}")
    fn, args = counted("entry", lambda: entry(device="cuda"), {})
    px = counted("entry fn", lambda: fn(*args),
                 {"raster_flat_nearest": 2, FRONTEND: 2})
    want, _ = args[0].render(args[1], 640, 480)
    check(np.array_equal(px.cpu().numpy().view(np.uint32), want),
          "entry(): fn(*args) differs from render")
    clis["entry"] = {"shape": list(px.shape), "equals_render": True}
    summary["clis"] = clis
    print(f"app CLIs: {json.dumps(clis)}", flush=True)

    # (c) The viewer on 127.0.0.1 at a port the OS picks: input events and
    # a resize sweep over HTTP, the bucketed FrameLoop on the card.
    try:
        import PIL  # noqa: F401
        jpeg = True
    except ImportError as exc:
        jpeg = False
        print(f"viewer: the JPEG half (encode_jpeg, /frame, /stream) did not "
              f"run: import PIL failed ({type(exc).__name__}: {exc}); the "
              "HTTP input and resize handling and the bucketed FrameLoop "
              "run on the card", flush=True)
    vloop = app.FrameLoop(scene, *VIEWER_START, device="cuda", bucketed=True,
                          stats=FrameStats(printer=None))
    server = ViewerServer(vloop, host="127.0.0.1", port=0, fps=0.0)
    thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.port}"
    frame = server.render_one if jpeg else server.step

    def post(obj):
        req = urllib.request.Request(f"{url}/input",
                                     data=json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            check(resp.status == 204, f"POST /input {obj}: {resp.status}")

    try:
        with urllib.request.urlopen(f"{url}/", timeout=10) as resp:
            check(b"pointerLock" in resp.read(), "GET /: not the page")
        reset_launches(raster)
        frame()
        post({"key": ["w", True], "capture": True})
        post({"mouse": [4.0, 2.0]})
        kb = vloop.keyboard
        check(kb.mouse_captured and kb.update_input(vloop.input).up == 1.0,
              "viewer: the keyboard state did not follow the events")
        f0 = frame().copy()
        check(bool((frame() != f0).any()), "viewer: moving did not move")
        for w, h in VIEWER_SIZES:
            post({"resize": [w, h]})
            px = frame()
            check(px.shape == (h, w) and (vloop.width, vloop.height) == (w, h),
                  f"viewer: resize to {w}x{h} gave {px.shape}")
        torch.cuda.synchronize()
        got = read_launches(raster)
        for k in COUNTED:
            launches[k] += got[k]
        buckets = {bucket_dims(*s) for s in (VIEWER_START,) + VIEWER_SIZES}
        check(vloop.renderer.graphs.captures == len(buckets),
              f"viewer: {vloop.renderer.graphs.captures} graphs for "
              f"{len(buckets)} buckets")
        check(got == {k: 2 * len(buckets) * (k in ("raster_flat_nearest",
                                                   FRONTEND))
                      for k in COUNTED}, f"viewer launches {got}")
        cpu_px, _ = Renderer(scene, device="cpu").render(
            vloop.camera.matrix, *VIEWER_SIZES[-1])
        check(np.array_equal(px, cpu_px),
              "viewer: the last frame differs from the CPU's")
        if jpeg:
            with urllib.request.urlopen(f"{url}/frame", timeout=10) as resp:
                check(resp.read()[:2] == b"\xff\xd8", "GET /frame: no JPEG")
            resp = urllib.request.urlopen(f"{url}/stream", timeout=10)
            threading.Timer(0.2, frame).start()
            check(b"--frame" in resp.fp.read(40), "GET /stream: no frame")
            resp.close()
        post({"key": ["w", False], "capture": False})
        check(not kb.mouse_captured
              and kb.update_input(vloop.input).up == 0.0,
              "viewer: the release events were not applied")
    finally:
        server.stop()
        server.httpd.server_close()
        thread.join(timeout=10)
    summary["viewer"] = {
        "jpeg": jpeg, "sizes": ["{}x{}".format(*s) for s in VIEWER_SIZES],
        "buckets": sorted("{}x{}".format(*b) for b in buckets),
        "captures": vloop.renderer.graphs.captures,
        "replays": vloop.renderer.graphs.replays, "launches": got,
        "last_frame_vs_cpu": "bit-equal", "backend": vloop.renderer.backend}
    print(f"app viewer: {json.dumps(summary['viewer'])}", flush=True)

    # (d) The "xla" backend: the default scene at both sizes and samplings
    # through Renderer(backend="xla") (captured), and stress 840 at 640x480
    # eager with larger chunks; card against CPU bit for bit, against the
    # "cuda" backend within the bound.
    xla = []
    pose = poses[XLA_POSE]
    for sampling in ("nearest", "bilinear"):
        cfg = RenderConfig(sampling=sampling)
        card = Renderer(scene, cfg, device="cuda", backend="xla")
        cpu = Renderer(scene, cfg, device="cpu", backend="xla")
        kern = renderers["default" if sampling == "nearest"
                         else "default bilinear"]
        for w, h in RESOLUTIONS:
            pg, dg = counted(f"xla {sampling} {w}x{h}",
                             lambda: card.render_device(pose, w, h),
                             {FRONTEND: 2})
            pc, dc = cpu.render(pose, w, h)
            to_cpu = compare(pg, dg, pc, dc,
                             f"xla card vs cpu {sampling} {w}x{h}")
            pk, dk = kern.render_device(pose, w, h)
            vs_cuda = bounded(pg, dg, pk, dk,
                              f"xla vs cuda backend {sampling} {w}x{h}")
            ms = torch.as_tensor(pose[None], device="cuda")
            eager = event_ms(torch, lambda: render_frames(
                card.dev, ms, width=w, height=h, config=cfg,
                backend="xla"), 3)
            pe, de = render_frames(card.dev, ms, width=w, height=h,
                                   config=cfg, backend="xla")
            compare(pg, dg, pe[0], de[0], f"xla captured vs eager {w}x{h}")
            replay = event_ms(torch, lambda: card.render_device(pose, w, h), 5)
            row = {"scene": "default", "sampling": sampling,
                   "at": f"{w}x{h}", "eager_frame_ms": spread(eager),
                   "captured_frame_ms": spread(replay),
                   "capture": card.graphs.captured[("exact", w, h, 1)],
                   "vs_cpu": to_cpu, "vs_cuda_backend": vs_cuda}
            xla.append(row)
            print(f"xla backend: {json.dumps(row)}", flush=True)
    stress = scenes["stress840"]
    w, h = COMPARE_SIZE
    cfg = RenderConfig()
    sdev = scene_to_device(stress, "cuda")
    m = torch.as_tensor(pose, device="cuda")
    frames = {}
    for chunk in XLA_STRESS_CHUNKS:
        frames[chunk] = counted(f"xla stress840 chunk {chunk}",
                                lambda: render_frame_xla(
                                    sdev, m, width=w, height=h, config=cfg,
                                    chunk=chunk), {FRONTEND: 1})
    a, b = (frames[c] for c in XLA_STRESS_CHUNKS)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "xla stress840: the frame depends on the chunk")
    eager = event_ms(torch, lambda: render_frame_xla(
        sdev, m, width=w, height=h, config=cfg,
        chunk=XLA_STRESS_CHUNKS[0]), 2)
    pk, dk = renderers["stress840"].render_device(pose, w, h)
    vs_cuda = bounded(a[0], a[1], pk, dk, f"xla vs cuda backend stress840 "
                      f"{w}x{h}")
    cdev = scene_to_device(stress, "cpu")
    y0, rows = XLA_STRESS_BAND
    setup = build_setup(cdev, torch.from_numpy(pose), width=w, height=h,
                        config=cfg)
    pb, db = raster_xla.rasterize(
        setup, cdev["textures"], width=w, height=rows, y_offset=y0,
        background=cfg.background_packed, chunk=XLA_STRESS_CHUNKS[0])
    to_cpu = compare(a[0][y0:y0 + rows], a[1][y0:y0 + rows], pb, db,
                     f"xla stress840 card vs cpu rows [{y0}, {y0 + rows})")
    row = {"scene": "stress840", "sampling": "nearest", "at": f"{w}x{h}",
           "chunks": list(XLA_STRESS_CHUNKS), "eager_frame_ms": spread(eager),
           "captured_frame_ms": "not measured (eager only)",
           "vs_cpu": dict(to_cpu, rows=[y0, y0 + rows]),
           "vs_cuda_backend": vs_cuda}
    xla.append(row)
    print(f"xla backend: {json.dumps(row)}", flush=True)
    summary["xla"] = xla

    # (e) steady_state_frame_time on the "cuda" backend (default, 1080p),
    # in turns with the back-to-back captured flight phase 8 times, and
    # beside phase 8's own reading.
    w, h = RESOLUTIONS[0]
    r = renderers["default"]

    def back_to_back():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for x in poses:
            r.render_device(x, w, h)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / len(poses)

    turns = {"steady_state_ms": [], "back_to_back_ms": []}
    for who in ("back_to_back_ms", "steady_state_ms", "steady_state_ms",
                "back_to_back_ms"):
        turns[who].append(
            back_to_back() if who == "back_to_back_ms" else 1e3
            * steady_state_frame_time(lambda x: r.render_device(x, w, h),
                                      np.stack(poses)))
    b2b8 = next(row["back_to_back_ms_per_frame"]["captured"]
                for row in captured if row["scene"] == "default"
                and row["at"] == f"{w}x{h}" and row["batch"] == 1)
    summary["steady_state"] = {"at": f"{w}x{h}", **turns,
                               "phase8_back_to_back_ms": b2b8}
    print(f"steady_state_frame_time default {w}x{h}: "
          f"{json.dumps(summary['steady_state'])}", flush=True)
    # The helper's chain less its empty chain is the same replayed frame as
    # the back-to-back flight's: its runs on the H100 read 4-5 % under the
    # flight timed in turns with it, and 19 % over phase 8's flight timed
    # minutes before. A quarter either way holds it to that frame.
    steady = statistics.median(turns["steady_state_ms"])
    b2b = statistics.median(turns["back_to_back_ms"])
    check(0.75 * b2b < steady < 1.25 * b2b,
          f"steady state {steady} ms against back to back {b2b} ms")
    return summary


# Phase 12: the front-end kernel's cells, (scene, size, B).
FRONTEND_CELLS = (("default", (1920, 1080), 1), ("default", (3840, 2160), 4),
                  ("stress840", (1920, 1080), 1),
                  ("stress840", (3840, 2160), 4))


def frontend_bytes(frontend, triangles: int, frames: int) -> int:
    """The least bytes ``frontend_setup`` moves: each corner array word and
    texture id read once, each frame's matrix, and every setup row of the
    frames' 2T slots (48 words and two bytes a slot) written once."""
    slot = sum(dtype.itemsize * math.prod(shape)
               for _, dtype, shape in frontend.SETUP_KEYS)
    return (triangles * (12 + 12 + 9 + 1) * 4 + frames * 12 * 4
            + frames * 2 * triangles * slot)


def frontend_phase(torch, arrays: dict, poses, card) -> list:
    """Phase 12: ``ops.frontend.frontend_setup`` against its plain version
    on the card, bit for bit (float bits as int32, so NaN compares too) and
    one launch a call, then both timed with the L2 cache cold beside the
    least time of the bytes the kernel must move, at each of
    FRONTEND_CELLS. Returns the kernels line's rows."""
    from swift3drenderer_tpu_torch.config import DEFAULT_CONFIG
    from swift3drenderer_tpu_torch.ops import frontend

    rows = []
    for scene, (width, height), b in FRONTEND_CELLS:
        arr = arrays[scene]
        m = torch.as_tensor(np.stack(poses[:b]), device="cuda")
        args = (arr["vert_c"], arr["norm_c"], arr["attr_c"], arr["tex_c"], m)
        kw = dict(width=width, height=height,
                  factor=DEFAULT_CONFIG.factor(height), half_w=width / 2.0,
                  half_h=height / 2.0, near=DEFAULT_CONFIG.near,
                  min_area=DEFAULT_CONFIG.min_area)
        before = frontend.frontend_setup.launches
        got = frontend.frontend_setup(*args, **kw)
        check(frontend.frontend_setup.launches == before + 1,
              "frontend_setup: not one launch a call")
        want = frontend.frontend_setup_plain(*args, **kw)
        for k, v in want.items():
            bits = (lambda x: x.view(torch.int32)) if v.dtype == torch.float32 \
                else (lambda x: x)
            check(torch.equal(bits(got[k]), bits(v)),
                  f"frontend_setup {scene} {width}x{height} B={b}: {k} is "
                  "not the plain version's")
        # The flush has to outlast the wrapper's host work (its checks and
        # sixteen allocations, ~0.15 ms), or the span holds that work too: on
        # an H100 a 512 MB flush read 14-157 µs where the kernel ran 7-10 µs.
        kernel_ms = time_cold_ms(
            torch, lambda: frontend.frontend_setup(*args, **kw),
            flush_bytes=2 << 30)
        plain_ms = time_cold_ms(torch, lambda: frontend.frontend_setup_plain(
            *args, **kw), reps=20)
        t = arr["vert_c"].shape[0]
        bound = bound_of(frontend_bytes(frontend, t, b), 0)
        row = {"kernel": "frontend_setup",
               "replaces": "none (swift3drenderer_tpu/renderer.py::"
                           "build_setup, left to XLA)",
               "scene": scene, "size": [width, height], "batch": b,
               "slots": 2 * t * b, "bit_equal": True, "card_ms": kernel_ms,
               "plain_ms": plain_ms, **bound, "library_ms": None}
        print(f"frontend_setup {scene} {width}x{height} B={b}: "
              f"{kernel_ms:.5f} ms L2 cold, plain {plain_ms:.5f} ms, bound "
              f"{bound['bound_ms']:.5f} ms ({bound['bytes']} bytes) on {card}",
              flush=True)
        rows.append(row)
    return rows


def stage_phase(torch, raster, scenes, renderers, errs, poses, card,
                setup_of, device="cuda") -> tuple:
    """Phase 11: the stage probes (tools/perf_probe.py's and
    tools/stress_probe.py's counterparts: the frame split into front-end,
    binning, the kernel's timing forms and the full frame, each stage a
    captured graph replayed over a short flight) with the timing forms'
    launch counts set to 0 just before and read just after; the full
    stage's frame against Renderer.render_device; the timing forms' rows of
    the kernels line (``errs`` holds phase 3's comparisons); and the native
    C++ core. Returns (timing rows, probe results, native results)."""
    from swift3drenderer_tpu_torch import Renderer, native
    from swift3drenderer_tpu_torch.config import DEFAULT_CONFIG
    from swift3drenderer_tpu_torch.golden import render_frame as golden_frame
    from swift3drenderer_tpu_torch.tools import (native_baseline, perf_probe,
                                                 stress_probe)
    bg = DEFAULT_CONFIG.background_packed
    reset_launches(raster)
    probes = {"perf_probe default": perf_probe.main(
        ["--configs", ",".join(f"{w}x{h}" for w, h in RESOLUTIONS),
         "--frames", str(PROBE_FRAMES), "--device", device])}
    check(stress_probe.main(["--objects", str(STRESS_OBJECTS), "--w",
                             str(RESOLUTIONS[0][0]), "--h",
                             str(RESOLUTIONS[0][1]), "--frames",
                             str(PROBE_FRAMES), "--device", device]) == 0,
          "stress_probe failed")
    if device == "cuda":
        torch.cuda.synchronize()
    timing_launches = read_timing_launches(raster)
    print(f"main path stage probes: launches "
          f"{json.dumps({**read_launches(raster), **timing_launches})}",
          flush=True)
    # Each probe cell captures each stage once: its warm-up and its capture
    # launch each form it runs (perf_probe: default at both sizes, flat;
    # stress_probe: stress 840 at 1080p, segmented).
    want = {"raster_flat_vis": 2 * len(RESOLUTIONS),
            "raster_flat_shade": 2 * len(RESOLUTIONS),
            "raster_segmented_vis": 2, "raster_segmented_shade": 2}
    check(timing_launches == want,
          f"stage probes: timing-form launches {timing_launches}, want {want}")
    # stress_probe's numbers, and the full stage's frame (replayed from its
    # graph) against Renderer.render_device, per probe cell.
    probes["stress_probe stress840"] = stress_probe.probe(
        "stress", STRESS_OBJECTS, *RESOLUTIONS[0], PROBE_FRAMES, device)
    probe_poses = perf_probe.flight(PROBE_FRAMES)
    for name, (w, h) in [("default", size) for size in RESOLUTIONS] + [
            ("stress840", RESOLUTIONS[0])]:
        stages = perf_probe.Stages(scenes[name], w, h, device=device)
        for m in (probe_poses[0], probe_poses[-1]):
            pix, depth = (t.clone() for t in stages.run("full", m))
            compare(pix, depth, *renderers[name].render_device(m, w, h),
                    f"perf_probe full stage vs Renderer.render_device {name} "
                    f"{w}x{h}")
        if stages.graphs is not None:
            stages.graphs.close()
    print(f"stage probes on {card}: {json.dumps(probes)}", flush=True)

    # The timing forms' rows: each form at its main shape (the flat route on
    # the default scene, the segmented on stress 840, 1920x1080, pose 0),
    # L2 cold, its plain version, and the least time for its work.
    width, height = RESOLUTIONS[0]
    timing_rows = []
    for form, replaces in TIMING_FORMS.items():
        route, phases = form.split("_")[1:]
        scene_name = "default" if route == "flat" else "stress840"
        arr = renderers[scene_name].dev
        tex = arr["textures"]
        kw = dict(width=width, height=height, background=bg, phases=phases)
        setup = setup_of(poses[0], width, height, arr)
        args = (*tree_binned(raster, route, setup, width, height),
                *tree_tables(raster, route, setup))
        if route == "flat":
            bound = flat_bound(raster, *args, tex, width, height, "nearest",
                               phases)
        else:
            bound = segmented_bound(raster, args[:6], *args[6:], tex, width,
                                    height, "nearest", phases)
        launch = getattr(raster, f"raster_{route}_nearest")
        plain = getattr(raster, f"raster_{route}_nearest_plain")
        e = list(errs[form].values())
        row = {"name": form, "route": "cuda",
               "source": "swift3drenderer_tpu_torch/csrc/raster.cu",
               "replaces": replaces, "launches": timing_launches[form],
               "max_abs_err": max(x["max_channel_err"] for x in e),
               "depth_max_abs_err": max(x["depth_max_abs_err"] for x in e),
               "frames_compared": len(e),
               "tolerance": "bit-equal pixels, depth and gids (checked)",
               "at": f"{scene_name} {width}x{height}",
               "ms": time_cold_ms(torch, lambda: launch(*args, tex, **kw)),
               "full_form_ms_same_call": time_cold_ms(
                   torch, lambda: launch(*args, tex, width=width,
                                         height=height, background=bg)),
               "plain_ms": time_ms(torch, lambda: plain(*args, tex, **kw), 2,
                                   warmup=1),
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
               "bytes": bound["bytes"], "flops": bound["flops"],
               "library_ms": None}
        timing_rows.append(row)
        print(f"timing form {form}: {json.dumps(row)}", flush=True)

    # The native core: built on this machine from native/src, the default
    # scene at 1920x1080 through Renderer(backend="native") over the flight
    # (golden < 0.2 % at tol 1), its host ms beside the card's captured
    # frame (Renderer.render, host arrays out), then the baseline configs.
    cpu_model = "not read"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                cpu_model = line.split(":", 1)[1].strip()
                break
    t0 = time.perf_counter()
    native.build()
    native_build_s = time.perf_counter() - t0
    host = Renderer(scenes["default"], backend="native")
    card_r = renderers["default"]
    host.render(poses[0], width, height)
    card_r.render(poses[0], width, height)
    native_ms, card_ms = [], []
    for m in poses:
        t0 = time.perf_counter()
        px, _ = host.render(m, width, height)
        native_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        card_px, _ = card_r.render(m, width, height)
        card_ms.append((time.perf_counter() - t0) * 1e3)
    gp, _ = golden_frame(scenes["default"], poses[-1], width, height)
    native_res = {
        "cpu": cpu_model, "build_s": native_build_s,
        "library": native.library_path(),
        "at": f"default {width}x{height}", "frames": len(poses),
        "native_ms_median": statistics.median(native_ms),
        "card_render_ms_median": statistics.median(card_ms),
        "golden_mismatch": pixel_mismatch_fraction(gp, px),
        "card_mismatch": pixel_mismatch_fraction(card_px, px)}
    print(f"native core on {cpu_model} beside the card ({card}): "
          f"{json.dumps(native_res)}", flush=True)
    check(native_res["golden_mismatch"] < GOLDEN_BOUND["nearest"],
          f"native default {width}x{height}: golden mismatch "
          f"{native_res['golden_mismatch']}")
    native_res["baseline"] = native_baseline.main(
        ["--frames-scale", str(NATIVE_BASELINE_SCALE)])
    return timing_rows, probes, native_res


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
    from swift3drenderer_tpu_torch.entry import dryrun_multichip
    from swift3drenderer_tpu_torch.parallel import (
        Mesh, ShardedRenderer, gather_batch, make_mesh, merge_depth_gid,
        render_batch_sharded, render_scene_sharded, sharding)
    from swift3drenderer_tpu_torch.renderer import (
        Renderer, bucket_dims, build_setup, render_frames, render_range,
        scene_to_device)

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
    errs = {k: {} for k in (*FORMS, *TIMING_FORMS)}

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

    # The timing forms (phases "vis" and "shade") of each kernel against
    # their plain versions, pixels, depth and gids bit for bit, untracked
    # and tracked: the flat kernels on the default scene and the segmented
    # ones on stress 840 at 1920x1080; and their depth against the full
    # form's.
    for route, name in (("flat", "default"), ("segmented", "stress840")):
        setup = setup_of(poses[0], width, height, arrays[name])
        tex = arrays[name]["textures"]
        kw = dict(width=width, height=height, background=bg)
        for sampling in ("nearest", "bilinear"):
            kernel = kernel_of(route, sampling)
            for track in (False, True):
                args = (*binned_for(route, setup, width, height),
                        *tables_for(route, setup,
                                    gids_for(setup) if track else None), tex)
                full = getattr(raster, kernel)(*args, track_ids=track, **kw)
                for phases in ("vis", "shade"):
                    got = getattr(raster, kernel)(*args, track_ids=track,
                                                  phases=phases, **kw)
                    want = getattr(raster, f"{kernel}_plain")(
                        *args, track_ids=track, phases=phases, **kw)
                    what = (f"{kernel} phases={phases} vs plain {name} "
                            f"{width}x{height}{', tracked' if track else ''}")
                    res = compare(*got[:2], *want[:2], what)
                    check(not track or torch.equal(got[2], want[2]),
                          f"{what}: gid planes differ")
                    check(torch.equal(got[1], full[1]),
                          f"{what}: depth differs from the full form's")
                    report(errs[f"raster_{route}_{phases}"],
                           (sampling, track), res, what)

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

    # The flat kernels' edges, each in all eight forms (both samplings,
    # untracked and tracked, a batch of frames whole and on a band at y0 >
    # 0) against the plain versions, pixels, depth and gids bit for bit: the
    # default scene at 1920x1080 (S = 102, not a multiple of 4), which has
    # tiles whose listed slots the cull drops all of; its slots with the
    # first 23 again (S = 125, the flat limit, and depth ties the earlier
    # slot must win); B = 4 at the ragged 333x217 (a block's tiles lie in
    # one frame); a band on the ragged 1366-pixel width; and the live slots
    # repeated, each bbox the whole frame, so that a block culls hundreds of
    # listed slots in several rounds.
    def hold_flat_forms(what, setup, width, height, band, tex):
        tracked = None
        for sampling in ("nearest", "bilinear"):
            name = kernel_of("flat", sampling)
            for track in (False, True):
                gids = gids_for(setup) if track else None
                for y0, rows in ((0, height), band):
                    args = (*binned_for("flat", setup, width, rows, y0),
                            *tables_for("flat", setup, gids), tex)
                    kw = dict(width=width, height=rows, background=bg,
                              y_offset=y0, track_ids=track)
                    got = getattr(raster, name)(*args, **kw)
                    want = getattr(raster, f"{name}_plain")(*args, **kw)
                    label = (f"{name} vs plain {what}, rows [{y0}, "
                             f"{y0 + rows}){', tracked' if track else ''}")
                    res = compare(*got[:2], *want[:2], label)
                    check(not track or torch.equal(got[2], want[2]),
                          f"{label}: gid planes differ")
                    report(errs[f"{name}_ids" if track else name],
                           ("edges", what, y0, sampling), res, label)
                    if track and y0 == 0:
                        tracked = want[2]
        return tracked

    width, height = RESOLUTIONS[0]
    two = setup_of(np.stack(poses[:2]), width, height, arrays["default"])
    one = {k: v[0] for k, v in two.items()}
    counts_one, ids_one = binned_for("flat", one, width, height)
    keep = raster.tile_cull_plain(counts_one, ids_one,
                                  *tables_for("flat", one), width=width,
                                  height=height)
    whole = int(((counts_one[:, 0] > 0) & ~keep.any(dim=1)).sum())
    print(f"default {width}x{height} pose 0: {whole} tiles whose listed slots "
          f"are all culled", flush=True)
    check(whole > 0, "no tile of the default scene has all its slots culled")
    tex = arrays["default"]["textures"]
    hold_flat_forms(f"default {width}x{height} B=2", two, width, height,
                    (270, 270), tex)
    dup = {k: torch.cat([v, v[:, :23]], dim=1) for k, v in two.items()}
    gid = hold_flat_forms(f"default + 23 repeated slots (S = 125) {width}x"
                          f"{height} B=2", dup, width, height, (270, 270), tex)
    check(bool(((gid >= 2 * GID_BASE) & (gid < 2 * GID_BASE + 23)).any()),
          "no repeated slot's first copy won a pixel (no depth tie)")
    hold_flat_forms(f"default {RAGGED_SMALL[0]}x{RAGGED_SMALL[1]} B=4",
                    setup_of(np.stack(poses[:4]), *RAGGED_SMALL,
                             arrays["default"]), *RAGGED_SMALL, (61, 100), tex)
    hold_flat_forms(f"default {RAGGED[0]}x{RAGGED[1]} B=2",
                    setup_of(np.stack(poses[:2]), *RAGGED, arrays["default"]),
                    *RAGGED, (250, 300), tex)
    live = torch.nonzero(one["live"])[:, 0]
    wide = {k: v[live.repeat(raster.FLAT_MAX_SLOTS // live.numel())][None]
            for k, v in one.items()}
    wide.update(xmin=torch.zeros_like(wide["xmin"]),
                xmax=torch.full_like(wide["xmax"], width - 1),
                ymin=torch.zeros_like(wide["ymin"]),
                ymax=torch.full_like(wide["ymax"], height - 1))
    hold_flat_forms(f"default's {live.numel()} live slots repeated, each bbox "
                    f"the whole frame, {width}x{height}", wide, width, height,
                    (270, 270), tex)

    # ---- 4. the main paths ----
    phase("4. main paths")
    launches = {k: 0 for k in COUNTED}

    def counted(name, fn, want):
        """``fn()`` with every COUNTED launch count set to 0 just before and
        read just after: it must equal ``want`` ({form: launches})."""
        reset_launches(raster)
        out = fn()
        torch.cuda.synchronize()
        got = read_launches(raster)
        print(f"main path {name}: launches {json.dumps(got)}", flush=True)
        check(got == {k: want.get(k, 0) for k in COUNTED},
              f"{name}: launches {got}, want {want}")
        for k in COUNTED:
            launches[k] += got[k]
        return out

    def drive(name, renderer, runs, want, batch=0, min_drawn=0.2):
        """Render ``runs`` ((width, height), poses): frame by frame, or in
        calls of ``batch`` poses through render_batch, with the launch counts
        set to 0 just before; check the counts just after against ``want``
        ({kernel: launches per captured graph}, and one front-end launch a
        graph; each counted twice: the graph's warm-up and its capture) and
        one replay a call, each frame, and (batches) each frame against its
        single-frame render."""
        want = {FRONTEND: 1, **want}
        graphs = renderer.graphs
        captures, replays = graphs.captures, graphs.replays
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
        new = graphs.captures - captures
        print(f"main path {name}: {len(frames)} frames in {n} calls, "
              f"{new} graphs captured, {graphs.replays - replays} replays, "
              f"launches {json.dumps(got)}", flush=True)
        check(new >= 1 and graphs.replays - replays == n,
              f"{name}: {new} captures and {graphs.replays - replays} "
              f"replays for {n} calls")
        check(got == {k: 2 * want.get(k, 0) * new for k in COUNTED},
              f"{name}: launches {got} for {new} captures, want {want} "
              "twice per capture")
        for k in COUNTED:
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
    ms4_np = np.stack(poses[:4])
    ms4 = torch.as_tensor(ms4_np, device=dev)
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
            {form: GRID[0] * GRID[1], FRONTEND: GRID[0] * GRID[1]})
        rows = [(torch.cat([p for p, _ in blocks[f * GRID[1]:(f + 1) * GRID[1]]],
                           dim=1),
                 torch.cat([d for _, d in blocks[f * GRID[1]:(f + 1) * GRID[1]]],
                           dim=1)) for f in range(GRID[0])]
        compare(torch.cat([p for p, _ in rows]), torch.cat([d for _, d in rows]),
                want_p, want_d, f"{name} render_batch_sharded grid vs render_batch")
        print(f"  {name}: the {GRID[0]}x{GRID[1]} grid's blocks stitch to "
              f"render_batch, bit for bit", flush=True)
        # The same blocks replayed: ShardedRenderer's graph of each rank
        # (a mesh that holds no group renders its block without one),
        # captured at the first call and replayed at the second.
        grid_r = [ShardedRenderer(scenes[name], mesh=Mesh(*GRID, r, dev, None,
                                                          None, None),
                                  device="cuda")
                  for r in range(GRID[0] * GRID[1])]
        for turn, want in (("captured", {form: 2 * len(grid_r),
                                         FRONTEND: 2 * len(grid_r)}),
                           ("replayed", {})):
            got = counted(
                f"{name} ShardedRenderer {GRID[0]}x{GRID[1]} grid blocks "
                f"{turn}", lambda: [sr._block(ms4_np, width, height)
                                    for sr in grid_r], want)
            for r, (block, sr) in enumerate(zip(got, grid_r)):
                compare(*block, *blocks[r],
                        f"{name} grid block {r} {turn} vs its eager block")
        check(all(sr.graphs.captures == 1 and sr.graphs.replays == 2
                  for sr in grid_r), f"{name}: grid blocks not one capture "
              "and one replay each")
        print(f"  {name}: the {GRID[0]}x{GRID[1]} grid's blocks captured and "
              "replayed bit-equal to their eager blocks", flush=True)

    # render_scene_sharded's rank ranges replayed from its graph cache: each
    # rank of the emulated N-rank meshes (a Mesh of one rank that holds no
    # group replays its range without a collective), called at poses 0, 1
    # and 0 (a capture, then two replays that read new matrices), each call
    # bit-equal to its eager render_range; the third calls' ranges merged
    # with merge_depth_gid give the single frame.
    scene_cache = render_scene_sharded.graphs
    scene_captures = []     # capture ms and reserved MiB of each key

    def capture_stats(arr, mesh):
        """The capture ms and reserved bytes of the key of (arr, mesh)."""
        return scene_cache.capture_stats(
            ("scene", *RESOLUTIONS[0], cfg, "cuda", mesh),
            [arr[k] for k in sorted(arr)])

    def record_capture(name, n, rank, mesh):
        stats = capture_stats(composites[name][0], mesh)
        scene_captures.append({
            "scene": name, "ranks": n, "rank": rank,
            "capture_ms": stats["capture_ms"],
            "reserved_mib": stats["reserved_bytes"] / 2 ** 20})

    ms3 = [torch.as_tensor(poses[i], device=dev) for i in (0, 1, 2)]
    for name, form in SCENE_SHARDED:
        arr = composites[name][0]
        want_p, want_d = renderers[name].render_device(poses[0], width, height)
        for n in SCENE_RANKS:
            acc = None
            for r in range(n):
                lo, count = rank_range(name, n, r)
                mesh_r = Mesh(1, n, r, dev, None, None, None)
                eager = [render_range(arr, m, lo=lo, count=count, width=width,
                                      height=height, config=cfg)
                         for m in ms3[:2]]
                captures = scene_cache.captures
                for call, (pose, want) in enumerate(((0, {form: 2}), (1, {}),
                                                     (0, {}))):
                    packed, graphed = counted(
                        f"{name} rank {r} of {n} replayed range, call {call}",
                        lambda: sharding._packed_range(
                            arr, ms3[pose], width=width, height=height,
                            config=cfg, mesh=mesh_r, backend="cuda"), want)
                    got = sharding._unpack(packed)
                    check(graphed, f"{name} rank {r} of {n}: not replayed")
                    compare(*got[:2], *eager[pose][:2], f"{name} rank {r} of "
                            f"{n} replayed range call {call} vs render_range")
                    check(torch.equal(got[2], eager[pose][2]),
                          f"{name} rank {r} of {n}: gid planes differ")
                check(scene_cache.captures - captures == 1,
                      f"{name} rank {r} of {n}: "
                      f"{scene_cache.captures - captures} captures in 3 calls")
                record_capture(name, n, r, mesh_r)
                got = tuple(p.clone() for p in got)
                acc = got if acc is None else merge_depth_gid(*acc, *got)
            compare(*acc[:2], want_p, want_d, f"{name} {n} replayed ranges "
                    "merged vs single render")
        print(f"  {name}: every rank of the {SCENE_RANKS}-rank meshes "
              "captured once, replayed bit-equal to its eager range; merged, "
              "the single render", flush=True)

    # A real NCCL process group of one rank (rank 0, an in-process store),
    # kept for phases 8 and 10 and destroyed when the run ends (main).
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = make_mesh(1, 1, device="cuda")
    # render_scene_sharded called three times (poses 0, 1, 2): one capture
    # (its warm-up and its captured launch), then replays; each call
    # bit-equal to render_device and to the eager range; the first call's
    # result unchanged after the third.
    for name, form in SCENE_SHARDED:
        arr = arrays[name]
        captures, replays = scene_cache.captures, scene_cache.replays
        held = []
        for call, want in enumerate(({form: 2}, {}, {})):
            pix, depth = counted(
                f"{name} render_scene_sharded, NCCL world of 1, call {call}",
                lambda: render_scene_sharded(arr, ms3[call], width=width,
                                             height=height, mesh=mesh), want)
            held.append((pix, depth))
            compare(pix, depth, *renderers[name].render_device(
                poses[call], width, height),
                f"{name} render_scene_sharded (NCCL, 1 rank) call {call} vs "
                "render_device")
            compare(pix, depth, *sharding._scene_range(
                arr, ms3[call], width=width, height=height, config=cfg,
                mesh=mesh, backend="cuda")[:2],
                f"{name} render_scene_sharded call {call} vs its eager range")
        compare(*held[0], *renderers[name].render_device(poses[0], width,
                                                         height),
                f"{name} render_scene_sharded: the first call's result after "
                "the third")
        check(scene_cache.captures - captures == 1
              and scene_cache.replays - replays == 3,
              f"{name} render_scene_sharded: "
              f"{scene_cache.captures - captures} captures and "
              f"{scene_cache.replays - replays} replays for 3 calls")
        record_capture(name, 1, 0, mesh)
    print("  NCCL: render_scene_sharded captured once a scene, replayed, "
          "bit-equal to render_device and to its eager range; held results "
          "kept", flush=True)
    for row in scene_captures:
        print(f"render_scene_sharded capture: {json.dumps(row)}", flush=True)
    # ShardedRenderer.render_batch replays its rank's block: the first call
    # captures (the warm-up and the captured launch), later calls launch
    # through the graph; the all_gather runs after each replay.
    sharded_r = ShardedRenderer(scenes["default"], mesh=mesh, device="cuda")
    want_b = renderers["default"].render_batch(ms4_np, width, height)
    eager_b = render_batch_sharded(sharded_r.dev, ms4, width=width,
                                   height=height, mesh=mesh)
    held = []
    for call, want in enumerate(({"raster_flat_nearest": 2, FRONTEND: 2},
                                 {}, {})):
        pix, depth = counted(
            f"default ShardedRenderer.render_batch, NCCL 1 x 1 mesh, call "
            f"{call}", lambda: sharded_r.render_batch(
                ms4_np if call != 1 else ms4_np[::-1].copy(), width, height),
            want)
        held.append((pix, depth))
        if call != 1:
            compare(pix, depth, *want_b, "ShardedRenderer.render_batch "
                    "(NCCL, 1 x 1) vs render_batch")
            compare(pix, depth, *eager_b, "ShardedRenderer.render_batch "
                    "(NCCL, 1 x 1) vs its eager block")
    compare(*held[0], *want_b, "ShardedRenderer.render_batch: a result "
            "after the next replays")
    compare(held[1][0].flip(0), held[1][1].flip(0), *want_b,
            "ShardedRenderer.render_batch of the reversed poses")
    check(sharded_r.graphs.captures == 1 and sharded_r.graphs.replays == 3,
          f"ShardedRenderer: {sharded_r.graphs.captures} captures, "
          f"{sharded_r.graphs.replays} replays for 3 calls of one key")
    print("  NCCL: ShardedRenderer.render_batch (captured once, replayed) "
          "bit-equal to the single-card renders and to the eager block",
          flush=True)

    # ShardedRenderer(backend="xla"): the rank's block rasterized with
    # ops.raster_xla, captured at the first call and replayed at the second,
    # bit-equal to Renderer(backend="xla").render_batch; no raster kernel
    # launches, and the front-end's at the capture.
    xla_sr = ShardedRenderer(scenes["default"], mesh=mesh, device="cuda",
                             backend="xla")
    xla_r = Renderer(scenes["default"], device="cuda", backend="xla")
    for call in range(2):
        ms_x = np.stack(poses[4 * call:4 * call + 4])
        got = counted(f"default ShardedRenderer(backend=\"xla\") B=4 "
                      f"{XLA_BATCH_SIZE[0]}x{XLA_BATCH_SIZE[1]}, call {call}",
                      lambda: xla_sr.render_batch(ms_x, *XLA_BATCH_SIZE),
                      {FRONTEND: 2} if call == 0 else {})
        compare(*got, *xla_r.render_batch(ms_x, *XLA_BATCH_SIZE),
                f"ShardedRenderer(backend=\"xla\") call {call} vs "
                "Renderer(backend=\"xla\").render_batch")
    check(xla_sr.graphs.captures == 1 and xla_sr.graphs.replays == 2,
          f"ShardedRenderer(backend=\"xla\"): {xla_sr.graphs.captures} "
          f"captures, {xla_sr.graphs.replays} replays for 2 calls")
    print("  NCCL: ShardedRenderer(backend=\"xla\") captured once, replayed "
          "bit-equal to Renderer(backend=\"xla\").render_batch", flush=True)

    # The multi-chip hook on every card: its ranks are processes of their
    # own (spawned, each an NCCL world on a FileStore of its own), which
    # count their launches and report them.
    t0 = time.perf_counter()
    hook = dryrun_multichip(torch.cuda.device_count())
    hook_s = time.perf_counter() - t0
    hook_launches = {k: sum(r[k] for r in hook["launches"]) for k in FORMS}
    print(f"main path dryrun_multichip({torch.cuda.device_count()}): "
          f"{hook_s:.1f} s, launches {json.dumps(hook_launches)}", flush=True)
    check(hook_launches["raster_flat_nearest"] > 0
          and hook_launches["raster_flat_nearest_ids"] > 0,
          f"dryrun_multichip: launches {hook_launches}")
    for k in FORMS:
        launches[k] += hook_launches[k]

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

    def render_call(renderer, ms, width, height, frames=render_frames):
        """The renderer's frames of the poses ``ms`` launched op by op,
        without a graph: the matrices copied to the card, then ``frames``
        (a tree's render_frames)."""
        return frames(renderer.dev, torch.as_tensor(
            np.stack(ms), device=dev), width=width, height=height,
            config=renderer.config)

    def call_times(renderer, calls, width, height, call=render_call):
        per_call = []
        for ms in calls:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(renderer, ms, width, height)
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end))
        return per_call

    def frame_times(renderer, ms, width, height):
        return call_times(renderer, [[m] for m in ms], width, height)

    for c in cells:
        (width, height), b, sampling = c["size"], c["batch"], c["sampling"]
        renderer = renderers[c["renderer"]]
        arr = renderer.dev
        tex = arr["textures"]
        calls = calls_of(c)
        per_call = call_times(renderer, calls, width, height)
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
    # by the kernel; G = 1 lists no slot by super-tile).
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
        pf, df = on_route("flat", lambda: render_call(
            renderers["default"], poses[:1], width, height))
        ps, ds = on_route("segmented", lambda: render_call(
            renderers["default"], poses[:1], width, height))
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
            per_call = call_times(renderers["default"], calls, width, height)
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

    # With --parent DIR: the four kernels and their tracking forms against
    # the parent tree's, each tree's kernel on its own binner's and packer's
    # outputs for the same setup table, L2 cold, in turns parent, this,
    # this, parent (the same card in one call): the flat kernels at their
    # 1080p and 4K main shapes, on the default scene's B = 4 batch and on
    # its band of rows [270, 540) at 1080p (all eight forms: each sampling,
    # untracked and tracked, batched and banded); the segmented ones at the
    # split's cells, and stress 840 at 4K at G = 1 in both trees: every wide
    # slot then lies on the residual broadband list, as in a scene whose
    # wide slots each cover more than K super-tiles.
    ab, frame_ab = [], []
    trees = {"this": raster}
    full_vs_parent = "not measured"
    if parent:
        trees["parent"] = load_parent(parent)
        # The frame's instances of both trees, built from each tree's
        # csrc/raster.cu: the same registers, no spills, the same SASS.
        parent_kernels = load_parent(parent, "kernels")
        full_vs_parent = same_as_parent(
            logs["raster.cu"], parent_kernels.build(), kernels.library_path(),
            parent_kernels.library_path())
        # (name, route, sampling, width, height, G, B, y0, rows)
        ab_cases = [("default", "flat", sampling, w, h, None, 1, 0, h)
                    for sampling in ("nearest", "bilinear")
                    for w, h in RESOLUTIONS]
        ab_cases += [("icosahedron bilinear", "flat", "bilinear",
                      *RESOLUTIONS[0], None, 1, 0, RESOLUTIONS[0][1])]
        ab_cases += [("default", "flat", sampling, *RESOLUTIONS[0], None, b,
                      y0, rows) for sampling in ("nearest", "bilinear")
                     for b, y0, rows in ((4, 0, RESOLUTIONS[0][1]),
                                         (1, 270, 270))]
        ab_cases += [(name if sampling == "nearest" else f"{name} bilinear",
                      "segmented", sampling, w, h, g, 1, 0, h)
                     for name, w, h, g in [(*c, None) for c in SPLIT_CELLS]
                     + [("stress840", *RESOLUTIONS[1], 1)]
                     for sampling in ("nearest", "bilinear")]
        for name, route, sampling, w, h, g, b, y0, rows in ab_cases:
            kernel = kernel_of(route, sampling)
            arr = composites.get(name, (arrays[name.split()[0]],))[0]
            setup = setup_of(np.stack(poses[:b]) if b > 1 else poses[0], w, h,
                             arr)
            kw = dict(width=w, height=rows, background=bg, y_offset=y0)
            seg = {} if g is None else {"g": g}
            for track in (False, True):
                gids = gids_for(setup) if track else None
                args = {who: (*tree_binned(r, route, setup, w, rows, y0, **seg),
                              *tree_tables(r, route, setup, gids),
                              arr["textures"]) for who, r in trees.items()}
                fns = {who: functools.partial(getattr(r, kernel), **seg)
                       for who, r in trees.items()}
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
                       "scene": name, "at": f"{w}x{h}", "batch": b,
                       "y0": y0, "rows": rows, "g": g,
                       "parent_ms": statistics.median(spans["parent"]),
                       "this_ms": statistics.median(spans["this"]),
                       "spans": spans}
                res["ratio"] = res["this_ms"] / res["parent_ms"]
                ab.append(res)
                print(f"A/B vs parent: {json.dumps(res)}", flush=True)

        # The whole eager frame (each tree's render_frames) against the
        # parent tree's on the same scene, the flight in turns parent, this,
        # this, parent; the default
        # scene (the flat route, the same code in both trees) shows what the
        # host's noise alone moves. And the segmented front-end's stages:
        # the parent's bin_segments against this tree's with
        # pack_slot_records, in the same turns.
        import importlib
        parent_module = importlib.import_module("s3d_parent.renderer")
        tree_frames = {"parent": parent_module.render_frames,
                       "this": render_frames}
        for name, (w, h) in (("default", RESOLUTIONS[0]),
                             ("stress840", RESOLUTIONS[0]),
                             ("stress840", RESOLUTIONS[1])):
            pair = {"parent": parent_module.Renderer(scenes[name],
                                                     device="cuda"),
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
                spans[who] += call_times(
                    pair[who], [[m] for m in poses], w, h,
                    call=functools.partial(render_call,
                                           frames=tree_frames[who]))
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
    flat_setups = {c: setup_of(np.stack(poses[:c[4]]) if c[4] > 1 else poses[0],
                               c[2], c[3], arrays[c[0]])
                   for c in FLAT_SPLIT_CELLS}
    split_flat = flat_split(torch, trees, flat_setups,
                            {c[0]: arrays[c[0]]["textures"]
                             for c in FLAT_SPLIT_CELLS}, bg)

    # ---- 8. captured frames: before the profiles of phase 6, whose
    # profiler session would inflate the host times taken after it ----
    phase("8. captured frames")

    def single_call(renderer, ms, width, height):
        return renderer.render_device(ms[0], width, height)

    def batch_call(renderer, ms, width, height):
        return renderer.render_batch(np.stack(ms), width, height)

    def eager_frames(renderer, ms, width, height, batch):
        """The eager pipeline's output shaped as the captured call's."""
        pix, depth = render_call(renderer, ms, width, height)
        return (pix, depth) if batch else (pix[0], depth[0])

    def same(got, want, what):
        """Bit-equal on the card; else compare() reports and raises."""
        if not all(tuple(a.shape) == tuple(b.shape) and torch.equal(a, b)
                   for a, b in zip(got, want)):
            compare(*got, *want, what)

    def spread(xs):
        return {"median": statistics.median(xs), "min": min(xs),
                "max": max(xs)}

    def back_to_back_ms(renderer, calls, width, height, call):
        """ms per call of the flight's calls issued with no
        synchronisation between them (CUDA events around all)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for ms in calls:
            call(renderer, ms, width, height)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / len(calls)

    # Every phase 5 cell: the replayed flight (its graphs captured in phase
    # 4) bit-equal to the eager flight, then timed in turns.
    captured = []
    for c in cells:
        (width, height), b = c["size"], c["batch"]
        renderer, calls = renderers[c["renderer"]], calls_of(c)
        call = batch_call if b else single_call
        for ms in calls:
            same(call(renderer, ms, width, height),
                 eager_frames(renderer, ms, width, height, b),
                 f"{c['name']} {width}x{height}: captured vs eager frame")
        fns = {"eager": render_call, "captured": call}
        spans = {"eager": [], "captured": []}
        flights = {"eager": [], "captured": []}
        for who in ("eager", "captured", "captured", "eager"):
            spans[who] += call_times(renderer, calls, width, height,
                                     call=fns[who])
            flights[who].append(back_to_back_ms(renderer, calls, width,
                                                height, fns[who]))
        host_us = []
        torch.cuda.synchronize()
        for ms in calls:
            t0 = time.perf_counter()
            call(renderer, ms, width, height)
            host_us.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        per = b or 1
        row = {"scene": c["name"], "at": f"{width}x{height}", "batch": per,
               "calls": len(calls),
               "eager_frame_ms": spread([x / per for x in spans["eager"]]),
               "captured_frame_ms": spread([x / per
                                            for x in spans["captured"]]),
               "back_to_back_ms_per_frame": {
                   who: statistics.median(v) / per
                   for who, v in flights.items()},
               "host_us_per_replay_call": statistics.median(host_us),
               "capture": renderer.graphs.captured[("exact", width, height,
                                                    per)]}
        captured.append(row)
        print(f"captured {c['name']} {width}x{height}: {json.dumps(row)}",
              flush=True)

    # The copy out of a graph's outputs (what keeps a result the caller's).
    copy_out = []
    for name, (width, height), b in (("default", RESOLUTIONS[0], 1),
                                     ("default", RESOLUTIONS[1], 1),
                                     ("default", RESOLUTIONS[0], 4)):
        pix, depth = render_call(renderers[name], poses[:b], width, height)
        res = {"at": f"{width}x{height}", "batch": b,
               "ms": time_ms(torch, lambda: (pix.clone(), depth.clone()), 20),
               "bytes": 2 * pix.numel() * 4}
        copy_out.append(res)
        print(f"copy out of a graph's outputs: {json.dumps(res)}", flush=True)

    # Results held across calls stay the caller's.
    held = [single_call(renderers["default"], [m], *RESOLUTIONS[0])
            for m in poses[:3]]
    held_b = [batch_call(renderers["default"], poses[i:i + 4], *RESOLUTIONS[0])
              for i in (0, 4)]
    for m, got in zip(poses[:3], held):
        same(got, eager_frames(renderers["default"], [m], *RESOLUTIONS[0], 0),
             "a frame held across later calls")
    for i, got in zip((0, 4), held_b):
        same(got, eager_frames(renderers["default"], poses[i:i + 4],
                               *RESOLUTIONS[0], 4),
             "a batch held across later calls")
    check(not torch.equal(held[0][0], held[2][0]), "held frames all equal")
    print("results held across calls: 3 frames and 2 batches still right",
          flush=True)

    # Bucketed frames against eager exact-size frames.
    buckets = []
    for name, sizes in (("default", ((320, 240), (300, 200), (333, 217),
                                     (512, 384), RAGGED, RESOLUTIONS[0])),
                        ("stress840", (RAGGED,))):
        renderer = renderers[name]
        before = renderer.graphs.captures
        for width, height in sizes:
            for pose in (0, FLIGHT_POSES // 2, FLIGHT_POSES - 1):
                pb, db = renderer.render(poses[pose], width, height,
                                         bucketed=True)
                pe, de = render_call(renderer, [poses[pose]], width, height)
                compare(pb, db, pe[0], de[0], f"{name} {width}x{height} pose "
                        f"{pose}: bucketed vs exact")
        res = {"scene": name, "sizes": [f"{w}x{h}" for w, h in sizes],
               "buckets": sorted({"{}x{}".format(*bucket_dims(w, h))
                                  for w, h in sizes}),
               "captures": renderer.graphs.captures - before,
               "capture": {"{}x{}".format(*k[1:3]): v for k, v in
                           renderer.graphs.captured.items()
                           if k[0] == "bucket"}}
        buckets.append(res)
        print(f"bucketed vs exact {name}: {json.dumps(res)}", flush=True)

    # The drag-resize sweep of tests/test_resize.py, twice: captures, then
    # replays only; each step bit-equal to the eager exact-size frame.
    resize = Renderer(scenes["tetrahedron"], device="cuda")
    steps = [(300 + 10 * i, 200 + 5 * i) for i in range(50)]
    sweeps = []
    for turn in range(2):
        step_ms = []
        for i, (width, height) in enumerate(steps):
            m = poses[i % FLIGHT_POSES]
            t0 = time.perf_counter()
            pb, db = resize.render(m, width, height, bucketed=True)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if turn == 0:
                pe, de = render_call(resize, [m], width, height)
                compare(pb, db, pe[0], de[0], f"resize step {i} "
                        f"{width}x{height}: bucketed vs exact")
        sweeps.append(step_ms)
    drag = {"steps": len(steps), "captures": resize.graphs.captures,
            "replays": resize.graphs.replays,
            "first_sweep_ms": sum(sweeps[0]),
            "step_ms_after_capture": spread(sweeps[1]),
            "capture": {"{}x{}".format(*k[1:3]): v
                        for k, v in resize.graphs.captured.items()}}
    print(f"drag-resize sweep 300x200 -> 790x445: {json.dumps(drag)}",
          flush=True)
    check(resize.graphs.captures <= 4,
          f"the drag sweep captured {resize.graphs.captures} times")

    # update_scene: graphs captured before it replay the moved scene.
    moved = scenes["default"].vertices.copy()
    moved[:, 0] += 0.5
    normals = scenes["default"].normals[::-1].copy()
    anim = Renderer(scenes["default"], device="cuda")
    before = anim.render_device(poses[0], *RESOLUTIONS[0])
    anim.render_batch(np.stack(poses40[:8]), *CONFIG1)
    anim.update_scene(vertices=moved, normals=normals)
    fresh = scene_to_device(dataclasses.replace(
        scenes["default"], vertices=moved, normals=normals), dev)
    for i, m in enumerate(poses[:4]):
        got = anim.render_device(m, *RESOLUTIONS[0])
        want = render_frames(fresh, torch.as_tensor(m[None], device=dev),
                             width=RESOLUTIONS[0][0],
                             height=RESOLUTIONS[0][1], config=cfg)
        same(got, (want[0][0], want[1][0]), f"update_scene pose {i}")
        check(i or not torch.equal(got[0], before[0]),
              "update_scene: the frame did not move")
    same(anim.render_batch(np.stack(poses40[:8]), *CONFIG1),
         render_frames(fresh, torch.as_tensor(np.stack(poses40[:8]),
                                              device=dev),
                       width=CONFIG1[0], height=CONFIG1[1], config=cfg),
         "update_scene batch")
    check(anim.graphs.captures == 2, "update_scene caused a capture")
    print("update_scene: 4 frames and a B = 8 batch replayed bit-equal to a "
          "fresh renderer's eager frames on the moved scene", flush=True)

    # ShardedRenderer.render_batch on phase 4's NCCL world of one, default
    # scene, B = 4 at 1920x1080 (the flight in 5 calls): eager (the rank's
    # block launched op by op, then the all_gather) against replayed (the
    # block's graph, then the all_gather), in turns eager, captured,
    # captured, eager.
    def sharded_eager_call(sr, ms, width, height):
        return gather_batch(sr.mesh, *render_batch_sharded(
            sr.dev, torch.as_tensor(np.stack(ms), device=dev), width=width,
            height=height, config=sr.config, mesh=sr.mesh))

    def sharded_captured_call(sr, ms, width, height):
        return sr.render_batch(np.stack(ms), width, height)

    width, height = RESOLUTIONS[0]
    sb_calls = [poses[i:i + 4] for i in range(0, len(poses), 4)]
    for ms in sb_calls:
        same(sharded_captured_call(sharded_r, ms, width, height),
             sharded_eager_call(sharded_r, ms, width, height),
             "ShardedRenderer.render_batch: replayed vs eager")
    sb_fns = {"eager": sharded_eager_call, "captured": sharded_captured_call}
    sb_spans = {"eager": [], "captured": []}
    sb_b2b = {"eager": [], "captured": []}
    for who in ("eager", "captured", "captured", "eager"):
        sb_spans[who] += call_times(sharded_r, sb_calls, width, height,
                                    call=sb_fns[who])
        sb_b2b[who].append(back_to_back_ms(sharded_r, sb_calls, width,
                                           height, sb_fns[who]))
    sharded_batch = {
        "scene": "default", "at": f"{width}x{height}", "batch": 4,
        "world": "NCCL, 1 rank", "calls": len(sb_calls), "card": card,
        "captures": sharded_r.graphs.captures,
        **{f"{who}_call_ms": spread(v) for who, v in sb_spans.items()},
        "back_to_back_ms_per_call": {who: statistics.median(v)
                                     for who, v in sb_b2b.items()}}
    check(sharded_r.graphs.captures == 1,
          f"ShardedRenderer: {sharded_r.graphs.captures} captures of one key")
    print(f"captured ShardedRenderer.render_batch ({card}): "
          f"{json.dumps(sharded_batch)}", flush=True)

    # render_scene_sharded on phase 4's NCCL world of one at 1920x1080 over
    # the flight (stress100k: its first POSES_100K poses): the replayed
    # sharded frame (the rank's range and pack from the function's graph
    # cache, then the merge, which makes no step on one rank, and the copy
    # out) against the captured frame (Renderer.render_device) and the eager
    # sharded frame (the range op by op, then the merge), each pose first
    # held bit-equal across the three, then timed in turns eager, replayed,
    # captured, captured, replayed, eager.
    def eager_sharded(arr, ms, width, height):
        return sharding._unpack(sharding._butterfly_merge(
            mesh, sharding._pack(*sharding._scene_range(
                arr, ms[0], width=width, height=height, config=cfg,
                mesh=mesh, backend="cuda"))))[:2]

    def replayed_sharded(arr, ms, width, height):
        return render_scene_sharded(arr, ms[0], width=width, height=height,
                                    mesh=mesh)

    width, height = RESOLUTIONS[0]
    scene_sharded = []
    for name, _ in SCENE_SHARDED:
        n_poses = POSES_100K if name == "stress100k" else FLIGHT_POSES
        host_calls = [[m] for m in poses[:n_poses]]
        dev_calls = [[torch.as_tensor(m, device=dev)] for m in poses[:n_poses]]
        arr, r = arrays[name], renderers[name]
        captures = scene_cache.captures
        for (m,), (mt,) in zip(host_calls, dev_calls):
            want = single_call(r, [m], width, height)
            same(replayed_sharded(arr, [mt], width, height), want,
                 f"{name}: replayed sharded frame vs captured frame")
            same(eager_sharded(arr, [mt], width, height), want,
                 f"{name}: eager sharded frame vs captured frame")
        turns = {"eager": [], "replayed": [], "captured": []}
        for who in ("eager", "replayed", "captured", "captured", "replayed",
                    "eager"):
            if who == "captured":
                turns[who] += call_times(r, host_calls, width, height,
                                         call=single_call)
            else:
                fn = eager_sharded if who == "eager" else replayed_sharded
                turns[who] += call_times(arr, dev_calls, width, height,
                                         call=fn)
        med = {who: statistics.median(v) for who, v in turns.items()}
        stats = capture_stats(arr, mesh)
        row = {"scene": name, "at": f"{width}x{height}",
               "world": "NCCL, 1 rank", "calls": n_poses, "card": card,
               **{f"{who}_frame_ms": spread(v) for who, v in turns.items()},
               "n1_overhead_replayed": med["replayed"] / med["captured"],
               "n1_overhead_eager": med["eager"] / med["captured"],
               "captures_in_phase": scene_cache.captures - captures,
               "capture_ms": stats["capture_ms"],
               "reserved_mib": stats["reserved_bytes"] / 2 ** 20}
        check(row["captures_in_phase"] == 0,
              f"{name}: render_scene_sharded captured again in phase 8")
        scene_sharded.append(row)
        print(f"replayed render_scene_sharded {name} ({card}): "
              f"{json.dumps(row)}", flush=True)

    # The default scene captured through either route (recorded only).
    route_r = {route: Renderer(scenes["default"], device="cuda")
               for route in ("flat", "segmented")}
    for route, r in route_r.items():
        for width, height in RESOLUTIONS:
            reset_launches(raster)
            on_route(route, lambda: r.render_device(poses[0], width, height))
            got = read_launches(raster)
            check(got[f"raster_{route}_nearest"] == 2 and got[FRONTEND] == 2,
                  f"{route} route capture: launches {got}")
    captured_routes = []
    for width, height in RESOLUTIONS:
        for m in poses:
            same(single_call(route_r["segmented"], [m], width, height),
                 single_call(route_r["flat"], [m], width, height),
                 f"captured default {width}x{height}: segmented vs flat route")
        spans = {"flat": [], "segmented": []}
        for route in ("flat", "segmented", "segmented", "flat"):
            spans[route] += call_times(route_r[route], [[m] for m in poses],
                                       width, height, call=single_call)
        res = {"at": f"{width}x{height}",
               **{f"{route}_captured_frame_ms": spread(v)
                  for route, v in spans.items()}}
        captured_routes.append(res)
        print(f"captured routes default {width}x{height}: {json.dumps(res)}",
              flush=True)

    # Profiles, last in this phase: the card's busy share, kernels per
    # replayed call and host copies of each captured flight, and each
    # route's device time per captured frame.
    for row, c in zip(captured, cells):
        (width, height), b = c["size"], c["batch"]
        renderer, calls = renderers[c["renderer"]], calls_of(c)
        call = batch_call if b else single_call
        prof = device_busy(torch, lambda: [call(renderer, ms, width, height)
                                           for ms in calls])
        row.update({"device_busy_share": prof["busy"],
                    "device_kernels_per_call": prof["launched"] / len(calls),
                    "device_us_per_frame": sum(prof["per_kernel"].values())
                    / len(c["ms"]),
                    "d2h_copies": prof["d2h"],
                    "scalar_reads": prof["scalar_reads"]})
        print(f"captured profile {c['name']} {width}x{height}: busy "
              f"{prof['busy']}, {row['device_kernels_per_call']} kernels per "
              f"replayed call, {row['device_us_per_frame']} device us per "
              f"frame, device-to-host copies {prof['d2h']}, scalar reads "
              f"{prof['scalar_reads']}", flush=True)
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"captured {c['name']} {width}x{height}: copied to the host")
    for res, (width, height) in zip(captured_routes, RESOLUTIONS):
        for route, r in route_r.items():
            prof = device_busy(torch, lambda: [
                single_call(r, [m], width, height) for m in poses])
            res[f"{route}_device_us_per_frame"] = (
                sum(prof["per_kernel"].values()) / len(poses))
            res[f"{route}_kernels_per_frame"] = prof["launched"] / len(poses)
            res[f"{route}_busy_share"] = prof["busy"]
        print(f"captured route profile default {width}x{height}: "
              f"{json.dumps(res)}", flush=True)
    # The replayed sharded frames, and every rank's replayed range of the
    # 8-rank stress100k mesh: no device-to-host copy and no scalar read.
    width, height = RESOLUTIONS[0]
    for row in scene_sharded:
        name = row["scene"]
        calls = [torch.as_tensor(m, device=dev)
                 for m in poses[:row["calls"]]]
        prof = device_busy(torch, lambda: [replayed_sharded(
            arrays[name], [mt], width, height) for mt in calls])
        row.update({"device_busy_share": prof["busy"],
                    "device_kernels_per_call": prof["launched"] / len(calls),
                    "device_us_per_frame": sum(prof["per_kernel"].values())
                    / len(calls),
                    "d2h_copies": prof["d2h"],
                    "scalar_reads": prof["scalar_reads"]})
        print(f"replayed render_scene_sharded profile {name}: busy "
              f"{prof['busy']}, {row['device_kernels_per_call']} kernels per "
              f"call, {row['device_us_per_frame']} device us per frame, "
              f"device-to-host copies {prof['d2h']}, scalar reads "
              f"{prof['scalar_reads']}", flush=True)
        check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
              f"replayed render_scene_sharded {name}: copied to the host")
    n = SCENE_RANKS[-1]
    prof = device_busy(torch, lambda: [sharding._packed_range(
        arrays["stress100k"], m0, width=width, height=height, config=cfg,
        mesh=Mesh(1, n, r, dev, None, None, None), backend="cuda")
        for r in range(n)])
    ranges_profile = {"scene": "stress100k", "ranks": n,
                      "device_busy_share": prof["busy"],
                      "device_kernels_per_range": prof["launched"] / n,
                      "d2h_copies": prof["d2h"],
                      "scalar_reads": prof["scalar_reads"]}
    print(f"replayed ranges profile: {json.dumps(ranges_profile)}",
          flush=True)
    check(prof["d2h"] == 0 and prof["scalar_reads"] == 0,
          f"stress100k's {n} replayed ranges: copied to the host")
    captured_summary = {"cells": captured, "copy_out": copy_out,
                        "bucketed": buckets, "drag_resize": drag,
                        "routes": captured_routes,
                        "sharded_batch": sharded_batch,
                        "scene_sharded": scene_sharded,
                        "scene_sharded_captures": scene_captures,
                        "replayed_ranges_profile": ranges_profile}

    phase("9. app and tooling")
    app_summary = app_phase(torch, scenes, poses, renderers, captured,
                            launches)

    # ---- 10. the validation matrix (tools/tpu_validate.py's cases and its
    # first VALIDATE_FUZZ fuzz draws, 100k included) on the card, each card
    # frame against golden and the CPU's frame; before the profiles of
    # phase 6, which would inflate its n1-overhead reading ----
    phase("10. validation matrix")
    from swift3drenderer_tpu_torch.tools import validate
    reset_launches(raster)
    rc = validate.main(["--fuzz", str(VALIDATE_FUZZ)])
    torch.cuda.synchronize()
    got = read_launches(raster)
    print(f"main path validation matrix: launches {json.dumps(got)}",
          flush=True)
    check(rc == 0, f"validation matrix: main returned {rc} (its FAIL lines "
          "above)")
    check(all(got[k] > 0 for k in VALIDATE_FORMS + (FRONTEND,)),
          f"validation matrix: launches {got}, want each of "
          f"{VALIDATE_FORMS + (FRONTEND,)} at least once")
    for k in COUNTED:
        launches[k] += got[k]
    print(f"validation matrix: ALL PASS on {card}", flush=True)

    # ---- 11. the stage probes and the native core; before the profiles of
    # phase 6 ----
    phase("11. stage probes and the native core")
    timing_rows, probes, native_res = stage_phase(
        torch, raster, scenes, renderers, errs, poses, card, setup_of)

    # ---- 12. the front-end kernel; before the profiles of phase 6 ----
    phase("12. front-end kernel")
    frontend_rows = frontend_phase(torch, arrays, poses, card)

    # ---- 6. device busy share of the flights, last: profiling leaves
    # host-side overhead behind it that would inflate the timings ----
    phase("6. profiles")
    for row, c in zip(table, cells):
        (width, height), b = c["size"], c["batch"]
        renderer, calls = renderers[c["renderer"]], calls_of(c)
        prof = device_busy(torch, lambda: [
            render_call(renderer, ms, width, height) for ms in calls])
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
            renderers["default"], ms, width, height) for ms in calls])
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
                render_call(renderers["default"], [m], width, height)
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

    def parent_ms(form, scene):
        """The parent's ms in the A/B at a form's main shape (``scene`` at
        1920x1080, one frame, y0 = 0)."""
        return next((x["parent_ms"] for x in ab if x["kernel"] == form
                     and x["scene"] == scene and x["at"] == "1920x1080"
                     and x["batch"] == 1 and x["y0"] == 0), "not measured")

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
            "parent_ms_same_call": parent_ms(name, main_scene),
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
            "parent_ms_same_call": parent_ms(f"{kernel}_ids", r["scene"]),
        }

    phase("7. probes")
    probe_rows = probes_phase(torch, parent)

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
    ] + [ids_row(k, ids_source) for k in KERNELS] + timing_rows + probe_rows \
        + [dict(r, launches=launches[FRONTEND]) for r in frontend_rows]
    print(json.dumps({"bands": bands, "composites": sharded,
                      "per_range_ms": range_ms, "merge_ms": merge_ms,
                      "ab_parent": ab or "not measured",
                      "frame_ab_parent": frame_ab or "not measured",
                      "split": split, "flat_split": split_flat,
                      "seg_sweep": seg_sweep, "captured": captured_summary,
                      "app": app_summary, "full_vs_parent": full_vs_parent,
                      "stage_probes": probes, "native": native_res}))
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
    finally:
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
