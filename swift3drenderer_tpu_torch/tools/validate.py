"""Counterpart of the repo's ``tools/tpu_validate.py``: the on-card validation
matrix. Every case renders through one of the port's paths on the card and is
held against the golden oracle (``swift3drenderer_tpu_torch.golden``), and,
where the TPU tool compared two device paths, the port's two paths are held
to each other bit for bit. On ``--device cuda`` each case also runs on the
CPU through the plain versions of the kernels, and the card's frames must
equal the CPU's bit for bit.

    python -m swift3drenderer_tpu_torch.tools.validate [--device cuda|cpu]
        [--fuzz N] [--no-100k]

Prints one PASS/FAIL line per case in the TPU tool's format, then ``ALL
PASS`` or ``N FAILURES``; returns 1 on any failure. Nothing is caught and
nothing falls back: a path that raises ends the run.

The cases are ``CASES``, one ``Case`` a row, in the order the TPU tool prints
them, and ``fuzz_case(k)``: the tool's k-th random draw (seed 7000 + k,
consumed in the tool's order), so port case k is TPU case k. The bound is
the port's, tighter than the TPU tool's 0.5 %: golden pixel mismatch <
0.2 % nearest and < 0.3 % bilinear at tol 1.

The shard_map-1dev and tri-sharded rows need a process group: they use the
initialised default group, or make one of one rank (NCCL on the card, gloo
on the CPU, an in-process store) and destroy it before ``main`` returns. The
CPU counterpart of a card run's sharded row is the CPU renderer's frame of
the same inputs, which a one-rank composite equals bit for bit. The
tri-sharded-n1-10k row's n1 overhead is the one-rank sharded frame's ms
over the renderer's frame's: on the card both replay a captured graph (the
sharded frame's rank range from ``render_scene_sharded``'s graph cache), as
the TPU tool compares two compiled frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..camera import Camera, Input
from ..config import DEFAULT_CONFIG, RenderConfig
from ..convert import resolve_device
from ..golden import render_frame as golden_render
from ..models import SCENES, stress100k_scene, stress_scene
from ..models.textures import default_texture_words
from ..ops import raster
from ..parallel import (ShardedRenderer, make_mesh, merge_depth_gid,
                        render_scene_sharded)
from ..renderer import Renderer, bucket_dims, build_setup, render_range

SIZE = (320, 240)                  # the TPU tool's frame
GOLDEN_BOUND = {"nearest": 0.002, "bilinear": 0.003}   # at tol 1
FUZZ_SEED = 7000
BUCKETED_SIZE = (300, 212)
TIMING_REPS = 10


def mismatch(a: np.ndarray, b: np.ndarray, tol: int = 1) -> float:
    """Fraction of pixels whose largest channel difference exceeds ``tol``
    (copy of ``tools/tpu_validate.py::mismatch``)."""
    def ch(p):
        p = p.astype(np.int64)
        return np.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], -1)
    return float((np.abs(ch(a) - ch(b)).max(-1) > tol).mean())


@dataclasses.dataclass(frozen=True)
class Case:
    """One row of the matrix. ``scene`` and ``pose`` are keys of
    ``build_scene`` and ``poses``; ``route`` is a key of ``ROUTES``, the port
    path the case drives; ``golden`` holds every frame the route renders to
    golden within GOLDEN_BOUND[sampling]; ``equal`` names what the route's
    frame must equal bit for bit ("" for nothing); ``replaces`` is the TPU
    case's lines in tools/tpu_validate.py."""
    name: str
    replaces: str
    scene: str
    pose: str
    size: Tuple[int, int]
    sampling: str
    route: str
    golden: bool = True
    equal: str = ""
    big: bool = False               # skipped under --no-100k


CASES = (
    Case("tetrahedron", ":46, :57-75", "tetrahedron", "identity", SIZE,
         "nearest", "render"),
    Case("icosahedron+bilinear", ":47, :57-75", "icosahedron", "identity",
         SIZE, "bilinear", "render"),
    Case("anisotropic", ":48, :57-75", "anisotropic", "identity", SIZE,
         "nearest", "render"),
    Case("clipping(fly)", ":49, :62-64", "clipping", "fly", SIZE, "nearest",
         "render"),
    Case("default", ":50, :57-75", "default", "identity", SIZE, "nearest",
         "render"),
    Case("regular_floor", ":51, :57-75", "regular_floor", "identity", SIZE,
         "nearest", "render"),
    Case("stress-3078slot", ":54, :57-75", "stress128", "identity", SIZE,
         "nearest", "render"),
    Case("tile_h=128", ":77-95", "default", "identity", SIZE, "nearest",
         "segmented", equal="the flat route's frame"),
    Case("tile_h=120", ":97-108", "stress128", "identity", SIZE, "nearest",
         "segmented g=1", equal="the renderer's frame"),
    Case("multipass-seq", ":110-131", "stress128", "identity", SIZE,
         "nearest", "ranges", equal="the one-pass frame"),
    Case("multipass-spatial128", ":119-131", "stress128", "identity", SIZE,
         "nearest", "bands", equal="the full frame"),
    Case("banded+bilinear", ":133-155", "default", "identity", SIZE,
         "bilinear", "bands", equal="the full frame"),
    Case("bucketed-resize", ":157-174", "default", "identity", BUCKETED_SIZE,
         "nearest", "bucketed", golden=False, equal="the exact-size frame"),
    Case("batch-B4-vs-single", ":176-194", "default", "batch4", SIZE,
         "nearest", "batch", equal="each single render"),
    Case("shard_map-1dev", ":196-214", "default", "identity", SIZE,
         "nearest", "sharded", equal="the renderer's frames"),
    Case("texture-paged-128", ":216-240", "paged128", "identity", SIZE,
         "nearest", "render"),
    Case("stress-10k-compact", ":242-259", "stress840", "pitched", SIZE,
         "nearest", "render"),
    Case("corners-ids-vs-seq10k", ":261-288", "stress840", "pitched", SIZE,
         "nearest", "tracked", equal="the untracked frame"),
    Case("stress100k-compact", ":290-310", "stress100k", "pitched", SIZE,
         "nearest", "render", big=True),
    Case("paged+batchB2", ":312-328", "paged128", "pair", SIZE, "nearest",
         "batch", equal="each single render"),
    Case("tri-sharded-n1-10k", ":330-364", "stress840", "pitched", SIZE,
         "nearest", "scene sharded", golden=False,
         equal="the renderer's frame"),
    Case("tile120+strip24", ":366-407", "stress128", "identity", SIZE,
         "nearest", "segmented k=4", equal="the renderer's frame"),
)


# ---------------------------------------------------------------------------
# Scenes and poses.

def paged_scene():
    """The TPU tool's 128-texture scene (tools/tpu_validate.py:219-230): the
    24-object stress field over 64 copies of the default pair of atlases,
    each triangle's textured corners on texture t % 128."""
    big_tex = np.concatenate([default_texture_words(2)] * 64)
    paged = stress_scene(seed=0, objects=24, textures=big_tex)
    tex = paged.attr_tex.copy()
    tri_tex = paged.attribute_indices.reshape(-1, 3)
    for t, corners in enumerate(tri_tex):
        for a in corners:
            if tex[a] >= 0:
                tex[a] = t % 128
    paged.attr_tex = tex
    paged.validate()
    return paged


def build_scene(key: str):
    """A case's scene: "family:seed" (the fuzz), "stress128" (3,078 slots),
    "stress840", "stress100k", "paged128", or a family at seed 0."""
    if ":" in key:
        family, seed = key.split(":")
        return SCENES[family](seed=int(seed))
    if key.startswith("stress") and key[6:].isdigit():
        return stress_scene(seed=0, objects=int(key[6:]))
    if key == "stress100k":
        return stress100k_scene(seed=0)
    if key == "paged128":
        return paged_scene()
    return SCENES[key](seed=0)


def poses() -> Dict[str, np.ndarray]:
    """The TPU tool's poses, each (3, 4) or (B, 3, 4) float32: identity
    (Camera().update(Input(), force_update=True)), fly (8 steps of
    Input(up=2.0) after it), pitched (one Input(mouse=(0, -35))), batch4
    (:180-184) and pair ([identity, pitched], :315)."""
    cam = Camera()
    identity = cam.update(Input(), force_update=True).copy()
    for _ in range(8):
        fly = cam.update(Input(up=2.0)).copy()
    cam = Camera()
    cam.update(Input(), force_update=True)
    pitched = cam.update(Input(mouse=(0.0, -35.0))).copy()
    cam = Camera()
    batch = [cam.update(Input(), force_update=True).copy()]
    for i in range(3):
        batch.append(cam.update(Input(up=1.0, mouse=(30.0 * i, 5.0))).copy())
    return {"identity": identity, "fly": fly, "pitched": pitched,
            "batch4": np.stack(batch), "pair": np.stack([identity, pitched])}


@dataclasses.dataclass(frozen=True)
class FuzzDraw:
    family: str
    seed: int
    sampling: str
    matrix: np.ndarray
    width: int
    height: int


def fuzz_draw(k: int) -> FuzzDraw:
    """The TPU tool's k-th fuzz draw (tools/tpu_validate.py:415-431), its
    generator consumed in the tool's order."""
    rng = np.random.default_rng(FUZZ_SEED + k)
    family = list(SCENES)[int(rng.integers(0, len(SCENES)))]
    seed = int(rng.integers(0, 100))
    sampling = "bilinear" if rng.integers(0, 4) == 0 else "nearest"
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    for _ in range(int(rng.integers(1, 6))):
        m = cam.update(Input(
            up=float(rng.uniform(0, 2)), down=float(rng.uniform(0, 1)),
            left=float(rng.uniform(0, 1)), right=float(rng.uniform(0, 1)),
            mouse=(float(rng.uniform(-120, 120)),
                   float(rng.uniform(-80, 80)))))
    w = int(rng.integers(20, 60)) * 8
    h = int(rng.integers(12, 40)) * 8
    return FuzzDraw(family, seed, sampling, m.copy(), w, h)


def fuzz_case(k: int) -> Case:
    d = fuzz_draw(k)
    return Case(f"fuzz[{k}]", ":409-441", f"{d.family}:{d.seed}", f"fuzz:{k}",
                (d.width, d.height), d.sampling, "render")


# ---------------------------------------------------------------------------
# The port's paths. A route renders a case on one device and returns a
# Result: the frames to hold to golden (and, on a card run, to the CPU's),
# the pairs of (pixels, depth) that must be equal bit for bit, and other
# named conditions that must hold.

@dataclasses.dataclass
class Result:
    frames: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # (m, pix, depth)
    pairs: List[Tuple[str, tuple, tuple]] = dataclasses.field(
        default_factory=list)
    note: str = ""
    checks: List[Tuple[str, bool]] = dataclasses.field(default_factory=list)


def _host(*planes) -> tuple:
    return tuple(p.cpu().numpy() for p in planes)


class Context:
    """What one run shares across cases: scenes, poses, renderers per
    (scene, sampling, device), and the one-rank mesh."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.poses = poses()
        self._scenes: Dict[str, object] = {}
        self._renderers: Dict[tuple, Renderer] = {}
        self._mesh = None
        self.owns_group = False

    def scene(self, key: str):
        if key not in self._scenes:
            self._scenes[key] = build_scene(key)
        return self._scenes[key]

    def pose(self, key: str) -> np.ndarray:
        if key.startswith("fuzz:"):
            return fuzz_draw(int(key[5:])).matrix
        return self.poses[key]

    def config(self, case: Case) -> RenderConfig:
        return dataclasses.replace(DEFAULT_CONFIG, sampling=case.sampling)

    def renderer(self, case: Case, device: torch.device) -> Renderer:
        key = (case.scene, case.sampling, device.type)
        if key not in self._renderers:
            self._renderers[key] = Renderer(self.scene(case.scene),
                                            self.config(case), device=device)
        return self._renderers[key]

    def mesh(self):
        """A 1 x 1 mesh on the default group, made of one rank here when no
        group is initialised."""
        if self._mesh is None:
            if not dist.is_initialized():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                dist.init_process_group(
                    "nccl" if self.device.type == "cuda" else "gloo",
                    store=dist.HashStore(), rank=0, world_size=1)
                self.owns_group = True
            self._mesh = make_mesh(1, 1, device=self.device)
        return self._mesh

    def close(self) -> None:
        if self.owns_group:
            dist.destroy_process_group()
            self.owns_group = False

    def ms(self, fn: Callable[[], object]) -> float:
        """ms per call of ``fn`` after a warm call: over TIMING_REPS calls
        between CUDA events on the card, one call on the host clock on the
        CPU (where the reading only shows that the path ran)."""
        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMING_REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / TIMING_REPS


def route_render(ctx: Context, case: Case, device) -> Result:
    """``Renderer(scene, config).render``: on the card a captured frame."""
    m = ctx.pose(case.pose)
    pix, depth = ctx.renderer(case, device).render(m, *case.size)
    return Result([(m, pix, depth)])


def route_segmented(ctx: Context, case: Case, device, k: int = raster.SEG_K,
                    g: int = raster.SEG_G) -> Result:
    """The frame's table through ``bin_segments(k, g)`` and the segmented
    kernel, whatever the scene's size (ops level)."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    w, h = case.size
    setup = build_setup(r.dev, torch.as_tensor(m, device=device), width=w,
                        height=h, config=r.config)
    trf, tri = raster.pack_setup_tables(setup)
    kernel = getattr(raster, f"raster_segmented_{case.sampling}")
    pix, depth = _host(*kernel(
        *raster.bin_segments(setup, width=w, height=h, k=k, g=g), trf, tri,
        raster.pack_slot_records(setup), r.dev["textures"], width=w, height=h,
        background=r.config.background_packed, g=g))
    want = _host(*r.render_device(m, w, h))
    return Result([(m, pix, depth)], [(case.equal, (pix, depth), want)],
                  f"K = {k}, G = {g}, {setup['live'].shape[-1]} slots")


def route_ranges(ctx: Context, case: Case, device, n: int = 3) -> Result:
    """The scene's triangles in ``n`` ranges (``render_range``), merged by
    (max 1/z, then min gid): the depth-merged composite of sequential
    passes."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    w, h = case.size
    t = r.dev["vert_c"].shape[0]
    local = -(-t // n)
    mt = torch.as_tensor(m, device=device)
    acc = None
    for i in range(n):
        out = render_range(r.dev, mt, lo=i * local, count=local, width=w,
                           height=h, config=r.config)
        acc = out if acc is None else merge_depth_gid(*acc, *out)
    pix, depth = _host(*acc[:2])
    return Result([(m, pix, depth)],
                  [(case.equal, (pix, depth), _host(*r.render_device(m, w, h)))],
                  f"{n} ranges of {local} triangles")


def route_bands(ctx: Context, case: Case, device, n: int = 2) -> Result:
    """The full frame's table rasterized as ``n`` row bands
    (``rasterize(y_offset=)``) and stitched."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    w, h = case.size
    setup = build_setup(r.dev, torch.as_tensor(m, device=device), width=w,
                        height=h, config=r.config)
    band = h // n
    parts = [raster.rasterize(setup, r.dev["textures"], width=w, height=band,
                              background=r.config.background_packed,
                              sampling=case.sampling, y_offset=i * band)
             for i in range(n)]
    pix, depth = _host(torch.cat([p for p, _ in parts]),
                       torch.cat([d for _, d in parts]))
    return Result([(m, pix, depth)],
                  [(case.equal, (pix, depth), _host(*r.render_device(m, w, h)))],
                  f"{n} bands of {band} rows")


def route_bucketed(ctx: Context, case: Case, device) -> Result:
    """``Renderer.render(..., bucketed=True)`` against the exact size."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    got = r.render(m, *case.size, bucketed=True)
    return Result([(m, *got)], [(case.equal, got, r.render(m, *case.size))],
                  "bucket {}x{}".format(*bucket_dims(*case.size)))


def route_batch(ctx: Context, case: Case, device) -> Result:
    """``Renderer.render_batch`` of the poses against one ``render`` each."""
    r = ctx.renderer(case, device)
    ms = ctx.pose(case.pose)
    pix, depth = _host(*r.render_batch(ms, *case.size))
    singles = [r.render(m, *case.size) for m in ms]
    return Result([(m, pix[i], depth[i]) for i, m in enumerate(ms)],
                  [(f"{case.equal} {i}", (pix[i], depth[i]), s)
                   for i, s in enumerate(singles)], f"B = {len(ms)}")


def _cpu_side(ctx: Context, device) -> bool:
    """True for the CPU half of a card run: the one-rank group's
    collectives run on the card, so that half renders without them."""
    return device.type == "cpu" and ctx.device.type == "cuda"


def route_sharded(ctx: Context, case: Case, device) -> Result:
    """``render_scene_sharded`` on the one-rank mesh, and
    ``ShardedRenderer.render_batch`` (on the card replayed from its graph),
    called twice, against the renderer's frames."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    w, h = case.size
    want = _host(*r.render_device(m, w, h))
    if _cpu_side(ctx, device):
        return Result([(m, *want)])
    mt = torch.as_tensor(m, device=device)
    got = _host(*render_scene_sharded(r.dev, mt, width=w, height=h,
                                      config=r.config, mesh=ctx.mesh()))
    sr = ShardedRenderer(ctx.scene(case.scene), r.config, mesh=ctx.mesh(),
                         device=device)
    first = _host(*sr.render_batch(m[None], w, h))
    second = _host(*sr.render_batch(m[None], w, h))
    pairs = [("render_scene_sharded vs render_device", got, want),
             ("ShardedRenderer.render_batch vs render_device",
              tuple(x[0] for x in first), want),
             ("ShardedRenderer.render_batch replayed vs first call", second,
              first)]
    if sr.graphs is None:
        return Result([(m, *got)], pairs, "ShardedRenderer eager")
    return Result([(m, *got)], pairs,
                  f"ShardedRenderer: {sr.graphs.captures} capture, "
                  f"{sr.graphs.replays} replays",
                  [("one capture, then replays", sr.graphs.captures == 1
                    and sr.graphs.replays == 2)])


def route_tracked(ctx: Context, case: Case, device) -> Result:
    """``render_range(lo=0, count=T)`` (the winners' gids tracked) against
    the untracked frame: pixels and depth equal, gid NO_GID exactly where
    depth is 0."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    w, h = case.size
    t = r.dev["vert_c"].shape[0]
    pix, depth, gid = _host(*render_range(
        r.dev, torch.as_tensor(m, device=device), lo=0, count=t, width=w,
        height=h, config=r.config))
    return Result([(m, pix, depth)],
                  [(case.equal, (pix, depth), _host(*r.render_device(m, w, h)))],
                  checks=[("gid NO_GID exactly where depth is 0", bool(
                      ((gid == raster.NO_GID) == (depth == 0)).all()))])


def route_scene_sharded(ctx: Context, case: Case, device) -> Result:
    """``render_scene_sharded`` on the one-rank mesh against the captured
    ``render_device``, bit for bit, and its time against the captured
    frame's (the TPU tool's n1 overhead). On the card the sharded frame
    replays its rank's range from the function's graph cache: the row
    checks that the first call captured and the timed calls replayed."""
    r = ctx.renderer(case, device)
    m = ctx.pose(case.pose)
    w, h = case.size
    want = _host(*r.render_device(m, w, h))
    if _cpu_side(ctx, device):
        return Result([(m, *want)])
    mt = torch.as_tensor(m, device=device)
    mesh = ctx.mesh()
    cache = render_scene_sharded.graphs
    captures = cache.captures

    def sharded():
        return render_scene_sharded(r.dev, mt, width=w, height=h,
                                    config=r.config, mesh=mesh)
    got = _host(*sharded())
    t_plain = ctx.ms(lambda: r.render_device(m, w, h))
    t_shard = ctx.ms(sharded)
    clock = "CUDA events" if ctx.device.type == "cuda" else "host clock"
    note = (f"n1-overhead {t_shard / max(t_plain, 1e-9):.2f}x "
            f"({t_plain:.3f} -> {t_shard:.3f} ms, {clock})")
    checks = []
    if device.type == "cuda":
        note += f"; replayed, {cache.captures - captures} capture"
        checks = [("one capture, then replays",
                   cache.captures - captures == 1)]
    return Result([(m, *got)], [(case.equal, got, want)], note, checks)


ROUTES: Dict[str, Callable[..., Result]] = {
    "render": route_render,
    "segmented": route_segmented,
    "segmented g=1": lambda ctx, case, device: route_segmented(
        ctx, case, device, g=1),
    "segmented k=4": lambda ctx, case, device: route_segmented(
        ctx, case, device, k=4),
    "ranges": route_ranges,
    "bands": route_bands,
    "bucketed": route_bucketed,
    "batch": route_batch,
    "sharded": route_sharded,
    "tracked": route_tracked,
    "scene sharded": route_scene_sharded,
}


# ---------------------------------------------------------------------------

def _equal(a: tuple, b: tuple) -> bool:
    return all(x.shape == y.shape and np.array_equal(x.view(np.uint8),
                                                     y.view(np.uint8))
               for x, y in zip(a, b, strict=True))


def run_case(ctx: Context, case: Case) -> Tuple[bool, str]:
    """Render ``case`` on the run's device (and on the CPU after a card
    run) and check it; returns (passed, the line's detail)."""
    res = ROUTES[case.route](ctx, case, ctx.device)
    scene = ctx.scene(case.scene)
    config = ctx.config(case)
    ok, notes = True, []
    frac = 0.0
    if case.golden:
        for m, pix, _ in res.frames:
            gp, _ = golden_render(scene, m, pix.shape[1], pix.shape[0],
                                  config=config)
            frac = max(frac, mismatch(gp, pix))
        ok = frac < GOLDEN_BOUND[case.sampling]
    for what, got, want in res.pairs:
        if not _equal(got, want):
            ok = False
            frac = max(frac, mismatch(got[0], want[0]))
            notes.append(f"NOT bit-equal: {what}")
    for what, holds in res.checks:
        ok &= holds
        if not holds:
            notes.append(f"does not hold: {what}")
    if case.equal and all(_equal(g, w) for _, g, w in res.pairs):
        notes.append(f"bit-equal to {case.equal}")
    if ctx.device.type == "cuda":
        cpu = ROUTES[case.route](ctx, case, torch.device("cpu"))
        same = len(cpu.frames) == len(res.frames) and all(
            _equal(g[1:], c[1:]) for g, c in zip(res.frames, cpu.frames))
        ok &= same
        notes.append("card = cpu" if same else "card != cpu")
    if res.note:
        notes.append(res.note)
    return ok, f"mismatch {frac * 100:.3f}%  [{'; '.join(notes)}]"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.tools.validate",
        description="The port's on-card validation matrix "
                    "(tools/tpu_validate.py's cases and fuzz).")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fuzz", type=int, default=0, metavar="N")
    ap.add_argument("--no-100k", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        label = torch.cuda.get_device_name(device)
    else:
        label = "cpu (the kernels' plain versions)"
    print(f"torch {torch.__version__}, device {label}", flush=True)
    ctx = Context(device)
    failures = 0
    try:
        for case in CASES:
            if case.big and args.no_100k:
                continue
            ok, detail = run_case(ctx, case)
            failures += not ok
            tris = ctx.scene(case.scene).num_triangles
            extra = ""
            if case.scene == "paged128":
                extra = (f"  atlas {ctx.scene(case.scene).textures.nbytes} "
                         "bytes")
            print(f"{'PASS' if ok else 'FAIL'}  {case.name:22s} "
                  f"({tris:5d} tris)  {detail}{extra}", flush=True)
        for k in range(args.fuzz):
            case = fuzz_case(k)
            ok, detail = run_case(ctx, case)
            failures += not ok
            family = case.scene.split(":")[0]
            print(f"{'PASS' if ok else 'FAIL'}  {case.name} {family:12s} "
                  f"{case.sampling:8s} {case.size[0]}x{case.size[1]}  "
                  f"{detail}", flush=True)
    finally:
        ctx.close()
    print("ALL PASS" if failures == 0 else f"{failures} FAILURES", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
