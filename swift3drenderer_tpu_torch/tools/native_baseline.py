"""The native C++ core at the baseline configs: the counterpart of the repo's
``tools/native_baseline.py``.

Mirrors ``tools/cpu_baseline/run_baseline.py`` config for config and pose for
pose: the reference harness (``tools/cpu_baseline/harness.cpp``) warms one
zero-input frame, then flies with up=2.0 and an accumulating mouse.x (+1.0 a
frame); this driver feeds ``native.NativeCamera`` the same input stream, so
frame N renders the same pose in both. Prints the JAX tool's table, with the
ratio of each config's frame rate to the reference C++ core's in
``tools/cpu_baseline/results.json`` (read from the repo; the ratio means
something only where both ran on the same machine).

    python -m swift3drenderer_tpu_torch.tools.native_baseline
        [--frames-scale S]

The library builds at first use (``native.load_native``). The JAX tool also
writes its results to ``tools/native_baseline_results.json``, a file of the
repo; this one prints them and ``main`` returns them.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

from ..models import SCENES
from ..native import NativeCamera, NativeRenderer

REFERENCE_RESULTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tools", "cpu_baseline", "results.json")

# (name, scene, width, height, fly, frames), as the JAX tool's.
CONFIGS = [
    ("tetrahedron-640x480", "tetrahedron", 640, 480, False, 60),
    ("icosahedron-1920x1080-fly", "icosahedron", 1920, 1080, True, 30),
    ("anisotropic-1920x1080", "anisotropic", 1920, 1080, False, 30),
    ("clipping-1920x1080-fly", "clipping", 1920, 1080, True, 30),
    ("full-3840x2160", "default", 3840, 2160, False, 15),
    ("full-1920x1080", "default", 1920, 1080, False, 30),
]


def run_config(scene_name: str, w: int, h: int, fly: bool, frames: int) -> dict:
    """One config: a warm frame at zero input, then ``frames`` timed frames
    of the harness's input stream. Returns the JAX tool's fields."""
    scene = SCENES[scene_name](seed=0)
    r = NativeRenderer(scene)
    cam = NativeCamera()
    mouse_x = 0.0
    m = cam.update(force_update=True)
    r.render(m, w, h)  # warm frame, zero input (harness.cpp:69)
    t0 = time.perf_counter()
    for _ in range(frames):
        if fly:
            mouse_x += 1.0
            m = cam.update(up=2.0, mouse=(mouse_x, 0.0))
        else:
            m = cam.update()
        pixels, _ = r.render(m, w, h)
    dt = (time.perf_counter() - t0) / frames
    checksum = int(pixels.astype("uint64").sum())
    return {
        "width": w, "height": h, "frames": frames,
        "ms_per_frame": round(dt * 1e3, 4), "fps": round(1.0 / dt, 3),
        "checksum": checksum, "triangles": scene.num_triangles,
        "Mpix_per_s": round(w * h / dt / 1e6, 2),
    }


def main(argv: Optional[List[str]] = None) -> dict:
    """Run every config at ``--frames-scale`` times its frame count and
    print the table; returns the results by config name."""
    ap = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.tools.native_baseline")
    ap.add_argument("--frames-scale", type=int, default=4,
                    help="multiply per-config frame counts (native core is "
                         "fast; more frames stabilize the timing)")
    args = ap.parse_args(argv)

    ref = {}
    if os.path.exists(REFERENCE_RESULTS):
        with open(REFERENCE_RESULTS) as f:
            ref = json.load(f)

    results = {}
    print(f"{'config':28s} {'ms/frame':>9s} {'fps':>9s} {'Mpix/s':>8s} "
          f"{'vs ref C++':>10s}")
    for name, scene_name, w, h, fly, frames in CONFIGS:
        res = run_config(scene_name, w, h, fly, frames * args.frames_scale)
        ratio = res["fps"] / ref[name]["fps"] if name in ref else float("nan")
        res["vs_reference"] = round(ratio, 2)
        results[name] = res
        print(f"{name:28s} {res['ms_per_frame']:9.2f} {res['fps']:9.2f} "
              f"{res['Mpix_per_s']:8.1f} {ratio:9.2f}x", flush=True)
    return results


if __name__ == "__main__":
    main()
