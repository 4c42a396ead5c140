"""Builds of the raster kernels that differ from the default in one constant
of ``csrc/raster.cu``, timed against it on the card.

    python -m swift3drenderer_tpu_torch.tools.seg_variants

Each variant is a copy of the package under ``_build/variants/<name>/`` whose
``csrc/raster.cu`` has one constant rewritten (``VARIANTS``), imported as a
package of its own, so that its kernels build from that copy into that
copy's ``_build/`` and nothing of this package is changed. A variant of a
segmented constant is timed on the segmented kernels: stress 840 at
1920x1080 and 3840x2160 and stress100k at 1920x1080; of a flat one
(``kFlat...``) on the flat kernels: the default scene at both sizes and in a
B = 4 batch at 1920x1080, and the icosahedron at 1920x1080 (pose 0 of
bench.py's flight, the batch its first four poses). Each variant's frame
must equal the default build's bit for bit; then both are timed with the L2
cold in turns default, variants, variants reversed, default. Prints each
build's ptxas register and spill lines and one JSON line per (cell,
sampling): the median ms of each build and its ratio to the default's.
Needs a card; the variants are measurements only, the package loads its
default build.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys

import numpy as np
import torch

from .. import kernels

# name: (the default's line in csrc/raster.cu, the variant's)
VARIANTS = {
    "chunk 64": ("constexpr int kChunk = 128;", "constexpr int kChunk = 64;"),
    "chunk 256": ("constexpr int kChunk = 128;", "constexpr int kChunk = 256;"),
    "8 blocks a SM": ("constexpr int kSegmentedBlocksPerSM = 6;",
                      "constexpr int kSegmentedBlocksPerSM = 8;"),
    "flat 1 tile": ("constexpr int kFlatTiles = 16;",
                    "constexpr int kFlatTiles = 1;"),
    "flat 4 tiles": ("constexpr int kFlatTiles = 16;",
                     "constexpr int kFlatTiles = 4;"),
    "flat 8 tiles": ("constexpr int kFlatTiles = 16;",
                     "constexpr int kFlatTiles = 8;"),
    "flat 32 tiles": ("constexpr int kFlatTiles = 16;",
                      "constexpr int kFlatTiles = 32;"),
    "flat 4 blocks a SM": ("constexpr int kFlatBlocksPerSM = 6;",
                           "constexpr int kFlatBlocksPerSM = 4;"),
    "flat 8 blocks a SM": ("constexpr int kFlatBlocksPerSM = 6;",
                           "constexpr int kFlatBlocksPerSM = 8;"),
}
# (route, scene, sampling, width, height, frames)
CELLS = tuple(("segmented", scene, sampling, w, h, 1)
              for scene, w, h in (("stress840", 1920, 1080),
                                  ("stress840", 3840, 2160),
                                  ("stress100k", 1920, 1080))
              for sampling in ("nearest", "bilinear"))
CELLS += tuple(("flat", "default", sampling, w, h, 1)
               for w, h in ((1920, 1080), (3840, 2160))
               for sampling in ("nearest", "bilinear"))
CELLS += (("flat", "icosahedron", "bilinear", 1920, 1080, 1),
          ("flat", "default", "nearest", 1920, 1080, 4))
STRESS_OBJECTS = 840          # bench.py's stress row: 10,083 triangles


def route_of(name: str) -> str:
    """The kernels variant ``name`` changes: "flat" or "segmented"."""
    return "flat" if "kFlat" in VARIANTS[name][0] else "segmented"


def variant_source(name: str) -> str:
    """csrc/raster.cu with variant ``name``'s constant rewritten; raises if
    the default's line is not in the source exactly once."""
    with open(os.path.join(kernels.CSRC, kernels.RASTER)) as f:
        src = f.read()
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise ValueError(f"variant {name!r}: {old!r} is not in "
                         f"csrc/{kernels.RASTER} exactly once")
    return src.replace(old, new)


def load_copy(alias: str, name: str, source: str, text: str):
    """A copy of the package under ``_build/variants/<name>/`` whose
    ``csrc/<source>`` is ``text``, imported as package ``alias``."""
    pkg = os.path.dirname(kernels.CSRC)
    root = os.path.join(kernels.BUILD_DIR, "variants",
                        name.replace(" ", "_"), os.path.basename(pkg))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(pkg, root, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    with open(os.path.join(root, "csrc", source), "w") as f:
        f.write(text)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def load_variant(index: int, name: str):
    """The variant's copy of the package, imported as ``s3d_variant<index>``:
    (its ops.raster, its kernels module)."""
    alias = f"s3d_variant{index}"
    load_copy(alias, name, kernels.RASTER, variant_source(name))
    return (importlib.import_module(f"{alias}.ops.raster"),
            importlib.import_module(f"{alias}.kernels"))


def time_cold_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device ms of ``fn`` with a 512 MB buffer written before each
    call (ten times the H100's L2), as chip_smoke.py times a launch."""
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
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


def main() -> list:
    from ..camera import Camera, Input
    from ..config import DEFAULT_CONFIG
    from ..models import SCENES
    from ..ops import raster
    from ..renderer import build_setup, scene_to_device

    builds = {"default": raster}
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        loaded = {name: load_variant(i, name) for i, name in enumerate(VARIANTS)}
        logs = dict(zip(["default", *loaded], pool.map(
            lambda k: k.build(k.RASTER),
            [kernels, *(k for _, k in loaded.values())])))
    builds.update({name: r for name, (r, _) in loaded.items()})
    for name, log in logs.items():
        print(f"build {name}: {'compiled' if log else 'already built'}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")

    cam = Camera()
    poses = [cam.update(Input(up=1.0, mouse=(2.0 * i, 0.0)),
                        force_update=(i == 0)).copy() for i in range(4)]
    scenes = {"stress840": SCENES["stress"](seed=0, objects=STRESS_OBJECTS),
              "stress100k": SCENES["stress100k"](seed=0),
              "default": SCENES["default"](seed=0),
              "icosahedron": SCENES["icosahedron"](seed=0)}
    out = []
    for route, scene, sampling, width, height, frames in CELLS:
        arr = scene_to_device(scenes[scene], "cuda")
        m = np.stack(poses[:frames]) if frames > 1 else poses[0]
        setup = build_setup(arr, torch.as_tensor(m, device="cuda"),
                            width=width, height=height, config=DEFAULT_CONFIG)
        tables = raster.pack_setup_tables(setup)
        if route == "flat":
            args = (*raster.bin_triangles(setup, width=width, height=height,
                                          tile_h=raster.TILE_H,
                                          tile_w=raster.TILE_W)[::-1],
                    *tables, arr["textures"])
        else:
            args = (*raster.bin_segments(setup, width=width, height=height),
                    *tables, raster.pack_slot_records(setup), arr["textures"])
        kw = dict(width=width, height=height,
                  background=DEFAULT_CONFIG.background_packed)
        kernel = f"raster_{route}_{sampling}"
        names = ["default"] + [n for n in loaded if route_of(n) == route]
        want = getattr(raster, kernel)(*args, **kw)
        spans = {name: [] for name in names}
        for name in names + names[::-1]:
            launch = getattr(builds[name], kernel)
            got = launch(*args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} build of {kernel} differs "
                                     f"from the default on {scene} "
                                     f"{width}x{height} B={frames}")
            spans[name].append(time_cold_ms(lambda: launch(*args, **kw)))
        ms = {name: statistics.median(v) for name, v in spans.items()}
        res = {"scene": scene, "at": f"{width}x{height}", "batch": frames,
               "kernel": kernel, "ms": ms,
               "ratio": {name: ms[name] / ms["default"] for name in ms}}
        out.append(res)
        print(f"variant: {json.dumps(res)}", flush=True)
    return out


if __name__ == "__main__":
    main()
