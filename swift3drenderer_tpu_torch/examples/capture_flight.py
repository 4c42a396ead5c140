"""Capture a scripted camera flight to PPM frames and a final PPM
(counterpart of ``examples/capture_flight.py``), over ``app.run_headless``.

Usage:
    python -m swift3drenderer_tpu_torch.examples.capture_flight \\
        [scene] [backend] [WxH] [frames] [--device cuda|cpu] [--out DIR]

Scenes: any of ``models.SCENES``, a data.bin path, or an OBJ. Backends:
cuda (default; the hand-written kernels), xla (the portable rasterizer) or
native (the C++ core on the host).
Writes ``DIR/flight_frames/`` (every 15th frame) and ``DIR/flight_final.ppm``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..app import run_headless
from ..models import SCENES
from ..utils.databin import load_scene
from ..utils.objio import load_obj
from ..utils.ppm import unpack_rgb_words, write_ppm


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.examples.capture_flight")
    p.add_argument("scene", nargs="?", default="default")
    p.add_argument("backend", nargs="?", default="cuda",
                   choices=["cuda", "xla", "native"])
    p.add_argument("size", nargs="?", default="640x400", metavar="WxH")
    p.add_argument("frames", nargs="?", type=int, default=90)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=".")
    args = p.parse_args(argv)
    width, height = (int(x) for x in args.size.split("x"))
    name, frames = args.scene, args.frames
    if name.endswith(".obj"):
        scene = load_obj(name, offset=(0, 0, -8))
    elif os.path.exists(name):
        scene = load_scene(name)
    else:
        scene = SCENES[name](seed=0)
    if frames < 1:
        raise SystemExit("frames must be >= 1")
    third = max(frames // 3, 1)
    # Last leg absorbs the remainder so the script covers exactly `frames`.
    last = max(frames - 2 * third, 0)
    script = f"{third}:w;{third}:w mx2" + (f";{last}:s mx-2" if last else "")
    pixels, _ = run_headless(
        scene, width=width, height=height, frames=frames, script=script,
        backend=args.backend, device=args.device,
        out_dir=os.path.join(args.out, "flight_frames"), out_every=15)
    write_ppm(os.path.join(args.out, "flight_final.ppm"),
              unpack_rgb_words(pixels))
    print(f"wrote {args.out}/flight_frames/ and {args.out}/flight_final.ppm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
