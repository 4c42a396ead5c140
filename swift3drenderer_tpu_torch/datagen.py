"""Scene data generator CLI — the offline tool counterpart of the reference's
data-generator program (reference data-generator/main.swift): composes a scene and
writes a byte-exact ``data.bin``, plus optional ripmap atlas (re)builds from plain
images. Unlike the reference (unseeded Float.random), orientation randomness is
seeded for reproducible golden tests. Copy of ``swift3drenderer_tpu.datagen``:
for the same arguments it writes the same bytes.

Usage:
    python -m swift3drenderer_tpu_torch.datagen --scene default --seed 0 --out data.bin
    python -m swift3drenderer_tpu_torch.datagen --atlas base.ppm --out atlas.ppm
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from .models import SCENES
from .utils.databin import dump_scene
from .utils.ppm import pack_rgb_words, read_ppm, write_ppm
from .utils.ripmap import build_ripmap_atlas


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m swift3drenderer_tpu_torch.datagen")
    p.add_argument("--scene", default="default", choices=sorted(SCENES))
    p.add_argument("--seed", default="0",
                   help="integer seed, or 'none' for OS entropy — the "
                        "reference generator's unseeded Float.random behavior "
                        "(data-generator/main.swift:13-32)")
    p.add_argument("--out", required=True)
    p.add_argument("--atlas", default=None, metavar="BASE_PPM",
                   help="instead of a scene, build a 512x512 ripmap atlas PPM "
                        "from a base image")
    p.add_argument("--obj", default=None, metavar="MESH_OBJ",
                   help="instead of a built-in scene, convert a Wavefront OBJ "
                        "mesh to data.bin")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--offset", type=float, nargs=3, default=(0.0, 0.0, -8.0))
    p.add_argument("--texture-ppm", action="append", default=[],
                   metavar="ATLAS_PPM",
                   help="use these 512x512 atlas PPMs as the scene textures "
                        "(in index order) instead of the procedural defaults")
    p.add_argument("--textures", default="procedural",
                   choices=("procedural", "photo"),
                   help="'photo' builds the atlases from real photographs "
                        "bundled with installed packages (visual parity with "
                        "the reference's painting artwork); default keeps the "
                        "seeded procedural textures")
    args = p.parse_args(argv)

    if args.atlas:
        atlas = build_ripmap_atlas(read_ppm(args.atlas))
        write_ppm(args.out, atlas)
        print(f"wrote ripmap atlas {args.out}")
        return 0

    if args.obj:
        from .utils.objio import load_obj
        scene = load_obj(args.obj, scale=args.scale, offset=tuple(args.offset))
        data = dump_scene(scene, args.out)
        print(f"wrote {args.out}: {len(data)} bytes, {scene.num_triangles} "
              f"triangles from {args.obj}")
        return 0

    textures = None
    if args.texture_ppm:
        words = []
        for path in args.texture_ppm:
            img = read_ppm(path)
            if img.shape[:2] != (512, 512):
                raise SystemExit(f"{path}: atlas PPM must be 512x512")
            words.append(pack_rgb_words(img))
        textures = np.stack(words).astype(np.uint32)
    elif args.textures == "photo":
        # Real-imagery default (the reference ships painting scans,
        # README.md:21): ripmap atlases built from bundled sample photos.
        from .models.textures import photo_texture_words
        textures = photo_texture_words(2)

    seed = None if str(args.seed).lower() == "none" else int(args.seed)
    scene = SCENES[args.scene](seed=seed, textures=textures) \
        if textures is not None else SCENES[args.scene](seed=seed)
    data = dump_scene(scene, args.out)
    print(f"wrote {args.out}: {len(data)} bytes, {scene.num_vertices} vertices, "
          f"{scene.num_triangles} triangles, {scene.num_textures} textures")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
