"""Stage anatomy of the large-scene route: the counterpart of the repo's
``tools/stress_probe.py``.

The JAX tool times the stress path it ships (``_rasterize_corners_compacted``:
a pre-live cull, then per-chunk clip, setup and live-compacted passes) with
the kernel stopped after each phase. The port renders any scene in one pass
with no compaction, so its large-scene route is ``rasterize`` over the whole
setup table on the segmented kernels, and the stages are
``tools.perf_probe``'s, timed the same way (``perf_probe.Stages``):

  prelive  the front-end: ``build_setup`` (the JAX tool's pre-live cull and
           compaction permutation)
  vis      front-end, binning and visibility (``phases="vis"``)
  shade    + shading, no texel fetch (``phases="shade"``)
  full     the frame

    python -m swift3drenderer_tpu_torch.tools.stress_probe [--scene stress]
        [--objects 840] [--w 1920] [--h 1080] [--frames 20]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from . import perf_probe

# This tool's stages, each by perf_probe's stage it runs.
STAGES = {"prelive": "setup", "vis": "vis", "shade": "shade", "full": "full"}


def stress_scene(scene_name: str, objects: int):
    """The scene as the JAX tool makes it: ``objects`` only for ``stress``."""
    return perf_probe.make_scene(scene_name,
                                 objects if scene_name == "stress" else 0)


def probe(scene_name: str = "stress", objects: int = 840, width: int = 1920,
          height: int = 1080, frames: int = 20,
          device="cuda") -> Dict[str, float]:
    """ms a frame of each of this tool's stages."""
    stages = perf_probe.Stages(stress_scene(scene_name, objects), width,
                               height, device)
    ms = stages.times(tuple(STAGES.values()), perf_probe.flight(frames))
    return {name: ms[stage] for name, stage in STAGES.items()}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.tools.stress_probe")
    p.add_argument("--scene", default="stress")
    p.add_argument("--objects", type=int, default=840)
    p.add_argument("--w", type=int, default=1920)
    p.add_argument("--h", type=int, default=1080)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    scene = stress_scene(args.scene, args.objects)
    print(perf_probe.device_line(args.device), flush=True)
    print(f"{scene.num_triangles} tris, {args.w}x{args.h}", flush=True)
    for name, ms in probe(args.scene, args.objects, args.w, args.h,
                          args.frames, args.device).items():
        print(f"{name:8s} {ms:7.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
