#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swift3drenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failed check raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel of the main path from csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, on the
     default scene's tables at 1920x1080 and 3840x2160, and the other scene
     families at a ragged 1366x768;
  4. drive the main path — Renderer(default_scene(seed=0), device="cuda") over
     bench.py's 20-pose flight at both resolutions — with the launch counts
     set to 0 just before and read just after, and hold its output against the
     plain CPU path on small frames (one of them ragged);
  5. time, with CUDA events after a warm-up: render_device per frame, the
     front-end stages, each kernel (with the L2 cache cold, as a frame finds
     it) and its plain version, beside the least time the card could take
     for the same work;
  6. the share of the flight's wall time the card is busy, and each kernel's
     device time per frame in the flight (torch.profiler).

The line before the last is one JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

RESOLUTIONS = ((1920, 1080), (3840, 2160))
FLIGHT_POSES = 20          # bench.py's flight: Input(up=1.0, mouse=(2.0*i, 0))
SMALL = (320, 240)         # the CPU reference frame size
RAGGED_SMALL = (333, 217)  # neither a multiple of the 32 x 8 tile
RAGGED = (1366, 768)       # 1366 is not a multiple of 32
MISMATCH_BOUND = 5e-4      # test_pallas_matches_xla's bound, tol 1
DEPTH_RTOL = 1e-4

# Published NVIDIA H100 SXM peaks (data sheet; at the full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Arithmetic of raster_flat_nearest, counted from its source: 12 flops for the
# three edge functions and 5 for 1/z per (pixel, binned slot); about 100 for
# the winner's shading (weights, three interpolations, three normalisations,
# headlight, level select and pack).
VIS_FLOPS = 17
SHADE_FLOPS = 100


class SmokeFailure(Exception):
    pass


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
    """Hold one (pixels, depth) pair against another; raise past the bounds."""
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
           "coverage_differs": int(((da > 0) != (db > 0)).sum())}
    check(mis < MISMATCH_BOUND, f"{what}: pixel mismatch {mis} >= {MISMATCH_BOUND}")
    check(rel <= DEPTH_RTOL, f"{what}: depth rel err {rel} > {DEPTH_RTOL}")
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


def device_busy(torch, fn):
    """Share of a window's wall time the card spends in kernels, the number
    of kernels launched, and each kernel's device time (µs summed over the
    window, by name), from the device-side events of a
    torch.profiler trace. Returns ("not measured", 0, {}) if the trace holds
    no device time."""
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
    launched = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launched += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    total = sum(per_kernel.values())
    if total <= 0:
        return "not measured", 0, {}
    return total / wall_us, launched, per_kernel


def flight(Camera, Input, n: int):
    cam = Camera()
    return [cam.update(Input(up=1.0, mouse=(2.0 * i, 0.0)),
                       force_update=(i == 0)).copy() for i in range(n)]


def raster_bound(raster, counts, ids, trf, tri, textures, width,
                 height) -> dict:
    """Least time the card could take for raster_flat_nearest on these
    inputs: the larger of bytes over HBM rate and fp32 flops over the fp32
    rate. Bytes, as this frame's data needs them: the tile counts; the binned
    entries of ``ids``; the table columns of the binned slots; the distinct
    atlas words the textured winners fetch (found by the plain version);
    both output planes written once. Flops: the binned slots of each pixel's
    tile, plus the shading of every pixel with a winner."""
    tile_w, tile_h = raster.TILE_W, raster.TILE_H
    ntx = -(-width // tile_w)
    c = counts.reshape(-1).to("cpu").numpy().astype(np.int64)
    ty, tx = np.divmod(np.arange(c.size), ntx)
    tile_px = (np.minimum(tile_w, width - tx * tile_w)
               * np.minimum(tile_h, height - ty * tile_h))
    best, win = raster.visibility_plain(counts, ids, trf, tri, width=width,
                                        height=height)
    covered = int((win >= 0).sum().item())
    binned = ids.to("cpu").numpy()[np.arange(ids.shape[1])[None, :] < c[:, None]]
    slots = np.unique(binned).size
    texels = int(raster.fetched_texels(best, win, trf, tri,
                                       textures.shape[0]).numel())
    nbytes = (c.size * 4 + int(c.sum()) * 4 + slots * (trf.shape[0]
              + tri.shape[0]) * 4 + texels * 4 + width * height * 8)
    flops = VIS_FLOPS * int((c * tile_px).sum()) + SHADE_FLOPS * covered
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops, "atlas_words_fetched": texels,
            "binned_slots_per_pixel": float((c * tile_px).sum() / (width * height))}


def run() -> dict:
    import torch

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

    from swift3drenderer_tpu_torch import Camera, Input, kernels
    from swift3drenderer_tpu_torch.config import DEFAULT_CONFIG
    from swift3drenderer_tpu_torch.models import SCENES, default_scene
    from swift3drenderer_tpu_torch.ops import raster
    from swift3drenderer_tpu_torch.renderer import (
        Renderer, build_setup, scene_to_device)

    # ---- 2. build ----
    t0 = time.perf_counter()
    log = kernels.build()
    build_s = time.perf_counter() - t0
    print(f"build: csrc/raster.cu {'compiled' if log else 'already built'} "
          f"in {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    bg = cfg.background_packed
    scene = default_scene(seed=0)
    dev_arrays = scene_to_device(scene, dev)
    poses = flight(Camera, Input, FLIGHT_POSES)

    def tables(m, width, height, arrays=dev_arrays):
        """The setup table of one frame, and the kernel's inputs from it."""
        mt = torch.as_tensor(m, device=dev)
        setup = build_setup(arrays, mt, width=width, height=height,
                            config=cfg)
        ids, counts = raster.bin_triangles(setup, width=width, height=height,
                                           tile_h=raster.TILE_H,
                                           tile_w=raster.TILE_W)
        trf, tri = raster.pack_setup_tables(setup)
        return setup, (counts, ids, trf, tri)

    # ---- 3. kernel vs plain version on the card ----
    vs_plain = {}
    for width, height in RESOLUTIONS:
        for pose in (0, FLIGHT_POSES - 1):
            _, args = tables(poses[pose], width, height)
            kw = dict(width=width, height=height, background=bg)
            pk, dk = raster.raster_flat_nearest(*args, dev_arrays["textures"], **kw)
            pp, dp = raster.raster_flat_nearest_plain(*args, dev_arrays["textures"], **kw)
            torch.cuda.synchronize()
            res = compare(pk, dk, pp, dp,
                          f"raster_flat_nearest vs plain {width}x{height} pose {pose}")
            vs_plain[(width, height, pose)] = res
            print(f"kernel vs plain {width}x{height} pose {pose}: "
                  f"{json.dumps(res)}", flush=True)

    # The other scene families, flown into (near-plane splits), at a frame
    # width that leaves a ragged column of tiles.
    cam = Camera()
    into = [cam.update(Input(up=2.0), force_update=(i == 0)).copy()
            for i in range(6)]
    for name in ("tetrahedron", "icosahedron", "anisotropic", "clipping"):
        arrays = scene_to_device(SCENES[name](seed=0), dev)
        for pose in (0, 5):
            _, args = tables(into[pose], *RAGGED, arrays=arrays)
            kw = dict(width=RAGGED[0], height=RAGGED[1], background=bg)
            pk, dk = raster.raster_flat_nearest(*args, arrays["textures"], **kw)
            pp, dp = raster.raster_flat_nearest_plain(*args, arrays["textures"], **kw)
            res = compare(pk, dk, pp, dp, f"raster_flat_nearest vs plain "
                          f"{name} {RAGGED[0]}x{RAGGED[1]} pose {pose}")
            vs_plain[(name, pose)] = res
            print(f"kernel vs plain {name} {RAGGED[0]}x{RAGGED[1]} pose {pose}: "
                  f"{json.dumps(res)}", flush=True)

    # ---- 4. the main path ----
    renderer = Renderer(scene, device="cuda")
    raster.raster_flat_nearest.launches = 0
    frames = {}
    for width, height in RESOLUTIONS:
        frames[(width, height)] = [renderer.render_device(m, width, height)
                                   for m in poses]
    torch.cuda.synchronize()
    launches = raster.raster_flat_nearest.launches
    n_frames = FLIGHT_POSES * len(RESOLUTIONS)
    print(f"main path: {n_frames} frames, raster_flat_nearest launches "
          f"{launches}", flush=True)
    check(launches == n_frames,
          f"raster_flat_nearest launched {launches} times for {n_frames} frames")
    for (width, height), outs in frames.items():
        for pix, depth in outs:
            check(tuple(pix.shape) == (height, width) and pix.dtype == torch.int32,
                  f"pixels {tuple(pix.shape)} {pix.dtype} at {width}x{height}")
            check(bool(torch.isfinite(depth).all()), "non-finite depth")
            check(bool((depth >= 0).all()), "negative depth")
        drawn = float((outs[0][0] != bg).float().mean())
        print(f"  {width}x{height} pose 0: {drawn:.3f} of pixels drawn")
        check(drawn > 0.2, f"only {drawn} of the frame drawn at {width}x{height}")
    cpu_renderer = Renderer(scene, device="cpu")
    for width, height in (SMALL, RAGGED_SMALL):
        for pose in (0, 10, FLIGHT_POSES - 1):
            pg, dg = renderer.render(poses[pose], width, height)
            pc, dc = cpu_renderer.render(poses[pose], width, height)
            res = compare(pg, dg, pc, dc,
                          f"cuda vs cpu renderer {width}x{height} pose {pose}")
            print(f"cuda vs cpu renderer {width}x{height} pose {pose}: "
                  f"{json.dumps(res)}", flush=True)

    # ---- 5. timings ----
    shapes = []
    for width, height in RESOLUTIONS:
        per_frame = []
        for m in poses:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            renderer.render_device(m, width, height)
            end.record()
            end.synchronize()
            per_frame.append(start.elapsed_time(end))
        frame_ms = statistics.median(per_frame)
        mt = torch.as_tensor(poses[0], device=dev)
        setup, (counts, ids, trf, tri) = tables(poses[0], width, height)
        tex = dev_arrays["textures"]
        kw = dict(width=width, height=height, background=bg)
        stage_ms = {
            "build_setup": time_ms(torch, lambda: build_setup(
                dev_arrays, mt, width=width, height=height, config=cfg), 50),
            "bin_triangles": time_ms(torch, lambda: raster.bin_triangles(
                setup, width=width, height=height, tile_h=raster.TILE_H,
                tile_w=raster.TILE_W), 50),
            "pack_setup_tables": time_ms(
                torch, lambda: raster.pack_setup_tables(setup), 50),
        }
        kernel_ms = time_cold_ms(torch, lambda: raster.raster_flat_nearest(
            counts, ids, trf, tri, tex, **kw))
        plain_ms = time_ms(torch, lambda: raster.raster_flat_nearest_plain(
            counts, ids, trf, tri, tex, **kw), 2, warmup=1)
        bound = raster_bound(raster, counts, ids, trf, tri, tex, width, height)
        row = {"at": f"{width}x{height}", "frame_ms_median": frame_ms,
               "frame_ms_min": min(per_frame), "frame_ms_max": max(per_frame),
               "stage_ms": stage_ms, "ms": kernel_ms, "plain_ms": plain_ms,
               **bound}
        shapes.append(row)
        print(f"timing {width}x{height}: {json.dumps(row)}", flush=True)

    # ---- 6. device busy share of the flight, last: profiling
    # leaves host-side overhead behind it that would inflate the timings ----
    for row, (width, height) in zip(shapes, RESOLUTIONS):
        busy, launched, per_kernel = device_busy(torch, lambda: [
            renderer.render_device(m, width, height) for m in poses])
        row["device_busy_share"] = busy
        row["device_kernels_per_frame"] = launched / FLIGHT_POSES
        # The kernel's device time per frame as the flight runs it.
        in_flight = sum(us for name, us in per_kernel.items()
                        if "raster_flat_nearest" in name)
        row["ms_in_flight"] = (in_flight / FLIGHT_POSES / 1e3 if in_flight
                               else "not measured")
        by_class = {}   # names cut to 60 characters group template instances
        for name, us in per_kernel.items():
            by_class[name[:60]] = by_class.get(name[:60], 0.0) + us
        top = dict(sorted(by_class.items(), key=lambda kv: kv[1],
                          reverse=True)[:5])
        print(f"profile {width}x{height}: device busy share {busy}, "
              f"{launched / FLIGHT_POSES} kernels per frame, raster_flat_"
              f"nearest {row['ms_in_flight']} ms per frame, top kernels "
              f"(us over {FLIGHT_POSES} frames) {json.dumps(top)}", flush=True)

    errs = list(vs_plain.values())
    main = shapes[0]
    kernel_row = {
        "name": "raster_flat_nearest",
        "route": "cuda",
        "source": "swift3drenderer_tpu_torch/csrc/raster.cu",
        "replaces": "swift3drenderer_tpu/ops/raster_pallas.py:249",
        "launches": launches,
        "max_abs_err": max(e["max_channel_err"] for e in errs),
        "depth_max_abs_err": max(e["depth_max_abs_err"] for e in errs),
        "pixel_mismatch": max(e["pixel_mismatch"] for e in errs),
        "tolerance": f"pixel mismatch < {MISMATCH_BOUND} at tol 1, depth rtol {DEPTH_RTOL}",
        "at": main["at"],
        "ms": main["ms"],
        "ms_in_flight": main["ms_in_flight"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shapes": [{k: r[k] for k in ("at", "ms", "ms_in_flight",
                                      "plain_ms", "bound_ms",
                                      "bound_by", "frame_ms_median",
                                      "device_busy_share",
                                      "device_kernels_per_frame")}
                   for r in shapes],
    }
    print(card)
    print(json.dumps({"kernels": [kernel_row]}))
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
