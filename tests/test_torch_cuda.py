"""The port's CUDA kernels on the card: ``raster_flat_nearest``,
``raster_segmented_nearest``, ``raster_flat_bilinear`` and
``raster_segmented_bilinear`` and their tracking forms against their plain
PyTorch versions, batched launches against single ones, stitched bands
against full frames, the flat kernels' culled tiles, depth ties, slot limit
and runs of tiles, the segmented kernels' super-tile lists, staged
slot records and residual filter at several K and G, and the CUDA renderer (single frames and
``render_batch``) against the CPU one, on the default scene and on a stress
field (3,078 slots, the segmented path); the captured frames (CUDA graphs)
against the eager frames, bucketed against exact, after ``update_scene``,
their ownership, counters and failed captures; the probes of
``swift3drenderer_tpu_torch.tools`` against their plain versions, the two
whose iterations run in chunks also replayed from a CUDA graph; the
app's flight and the ``"xla"`` backend on the card against the CPU; and
``ShardedRenderer.render_batch`` replayed from its graph (on an NCCL world
of one rank, and each block of an emulated 2 x 4 grid) against its eager
block; ``render_scene_sharded`` replayed from its graph cache (on an NCCL
world of one rank, and each rank's range of emulated meshes) against
``render_device`` and its eager range; ``ShardedRenderer(backend="xla")``
against ``Renderer(backend="xla")``; ``entry.dryrun_multichip`` on
every card; the kernels' timing forms (``phases="vis"`` and ``"shade"``)
against their plain versions, and the stage probe's graphs
(``tools.perf_probe.Stages``) against the renderer's frame.

Each test needs a CUDA card (and nvcc, which builds the kernel at first use)
and skips without one. The file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed, without tests/conftest.py (which imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch import renderer as trenderer
from swift3drenderer_tpu_torch.models import SCENES
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.renderer import build_setup, scene_to_device
from swift3drenderer_tpu_torch.tools import _probe
from swift3drenderer_tpu_torch.tools import fetch_microbench as pfm
from swift3drenderer_tpu_torch.tools import probe_dynamic_grid as pdg
from swift3drenderer_tpu_torch.tools import probe_gather2d as pg2
from swift3drenderer_tpu_torch.tools import probe_packed_fetch as ppf

W, H = 320, 240
RAGGED = (333, 217)      # neither a multiple of the 32 x 8 tile
BG = port.DEFAULT_CONFIG.background_packed


def flight(n):
    """bench.py's flight: one step forward and a turn per frame."""
    cam = port.Camera()
    return [cam.update(port.Input(up=1.0, mouse=(2.0 * i, 0.0)),
                       force_update=(i == 0)).copy() for i in range(n)]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(W, H), RAGGED])
def test_kernel_matches_plain_on_cuda(size):
    """The CUDA kernel against its plain version on the card, bit for bit:
    both round every operation alike."""
    need_card()
    w, h = size
    dev = scene_to_device(SCENES["default"](seed=0), "cuda")
    for m in flight(12)[::4]:
        setup = build_setup(dev, torch.as_tensor(m, device="cuda"), width=w,
                            height=h, config=port.DEFAULT_CONFIG)
        ids, counts = tr.bin_triangles(setup, width=w, height=h,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        trf, tri = tr.pack_setup_tables(setup)
        before = tr.raster_flat_nearest.launches
        pk, dk = tr.raster_flat_nearest(counts, ids, trf, tri, dev["textures"],
                                        width=w, height=h, background=BG)
        pp, dp = tr.raster_flat_nearest_plain(counts, ids, trf, tri,
                                              dev["textures"], width=w,
                                              height=h, background=BG)
        torch.cuda.synchronize()
        assert tr.raster_flat_nearest.launches == before + 1
        assert torch.equal(pk, pp) and torch.equal(dk, dp)
        assert bool((pk != BG).any())


@pytest.mark.cuda
def test_cuda_renderer_equals_cpu_renderer():
    """Every op of the port rounds alike on the card and the CPU, so the two
    renderers agree bit for bit, ragged frame sizes included."""
    need_card()
    scene = SCENES["default"](seed=0)
    on_card = port.Renderer(scene, device="cuda")
    on_cpu = port.Renderer(scene, device="cpu")
    for m in flight(12):
        for w, h in ((W, H), RAGGED):
            pg, dg = on_card.render(m, w, h)
            pc, dc = on_cpu.render(m, w, h)
            np.testing.assert_array_equal(pg, pc)
            np.testing.assert_array_equal(dg, dc)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(W, H), RAGGED])
def test_segmented_kernel_matches_plain_on_cuda(size):
    """raster_segmented_nearest against its plain version on the card, bit
    for bit, on stress_scene(objects=128): at the default G (the wide slots
    listed by super-tile) and at G = 2 (some left on the residual list)."""
    need_card()
    w, h = size
    dev = scene_to_device(SCENES["stress"](seed=0, objects=128), "cuda")
    for m in flight(12)[::4]:
        setup = build_setup(dev, torch.as_tensor(m, device="cuda"), width=w,
                            height=h, config=port.DEFAULT_CONFIG)
        tables = tables_for("segmented", setup)
        for g in (tr.SEG_G, 2):
            binned = tr.bin_segments(setup, width=w, height=h, g=g)
            kw = dict(width=w, height=h, background=BG, g=g)
            before = tr.raster_segmented_nearest.launches
            pk, dk = tr.raster_segmented_nearest(*binned, *tables,
                                                 dev["textures"], **kw)
            pp, dp = tr.raster_segmented_nearest_plain(*binned, *tables,
                                                       dev["textures"], **kw)
            torch.cuda.synchronize()
            assert tr.raster_segmented_nearest.launches == before + 1
            assert torch.equal(pk, pp) and torch.equal(dk, dp)
            assert bool((pk != BG).any())
            ntiles = tr.seg_lists(w, h, g)[0]
            assert int(binned[2][ntiles:].sum()) > 0
            assert g == tr.SEG_G or int(binned[4][0]) > 0


@pytest.mark.cuda
def test_cuda_renderer_equals_cpu_renderer_on_stress():
    """The segmented path: one raster_segmented_nearest launch per frame on
    the card, and the same frames as the CPU renderer, bit for bit. The
    frame is captured once per size (its warm-up and its capture each pass
    through the wrapper) and replayed for every call."""
    need_card()
    scene = SCENES["stress"](seed=0, objects=128)
    on_card = port.Renderer(scene, device="cuda")
    on_cpu = port.Renderer(scene, device="cpu")
    calls = 0
    for m in flight(12)[::3]:
        for w, h in ((W, H), RAGGED):
            flat, seg = (tr.raster_flat_nearest.launches,
                         tr.raster_segmented_nearest.launches)
            captures = on_card.graphs.captures
            pg, dg = on_card.render(m, w, h)
            calls += 1
            new = on_card.graphs.captures - captures
            assert tr.raster_segmented_nearest.launches == seg + 2 * new
            assert tr.raster_flat_nearest.launches == flat
            pc, dc = on_cpu.render(m, w, h)
            np.testing.assert_array_equal(pg, pc)
            np.testing.assert_array_equal(dg, dc)
    assert on_card.graphs.captures == 2
    assert on_card.graphs.replays == calls


def tables_for(route, setup, gids=None):
    """The tables the route's kernels take after the bins: (trf, tri), and
    the slot records for the segmented kernels."""
    trf, tri = tr.pack_setup_tables(setup, gids)
    if route == "flat":
        return trf, tri
    return trf, tri, tr.pack_slot_records(setup)


def setups_on_card(name, ms, w, h, **scene_kw):
    """The card's setup table of each pose, and the batch's (B = len(ms))."""
    dev = scene_to_device(SCENES[name](seed=0, **scene_kw), "cuda")
    batch = build_setup(dev, torch.as_tensor(np.stack(ms), device="cuda"),
                        width=w, height=h, config=port.DEFAULT_CONFIG)
    return dev, batch


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flat", "segmented"])
def test_bilinear_kernels_match_plain_on_cuda(route):
    """raster_flat_bilinear (default scene) and raster_segmented_bilinear
    (stress_scene(objects=128)) against their plain versions on the card,
    bit for bit, frame by frame."""
    need_card()
    w, h = RAGGED
    name, kw = (("default", {}) if route == "flat"
                else ("stress", {"objects": 128}))
    dev, batch = setups_on_card(name, flight(12)[::4], w, h, **kw)
    kernel = getattr(tr, f"raster_{route}_bilinear")
    plain = getattr(tr, f"raster_{route}_bilinear_plain")
    for b in range(3):
        setup = {k: v[b] for k, v in batch.items()}
        tables = tables_for(route, setup)
        binned = binned_for(route, setup, w, h)
        before = kernel.launches
        pk, dk = kernel(*binned, *tables, dev["textures"], width=w, height=h,
                        background=BG)
        pp, dp = plain(*binned, *tables, dev["textures"], width=w, height=h,
                       background=BG)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(pk, pp) and torch.equal(dk, dp)
        assert bool((pk != BG).any())


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_batched_launch_equals_single_launches_on_cuda(sampling):
    """A B = 3 batch in one launch of each kernel equals the three frames
    launched one by one, bit for bit; and the card's render_batch equals the
    CPU renderer's frames."""
    need_card()
    w, h = RAGGED
    ms = flight(12)[::4]
    for route, name, kw in (("flat", "default", {}),
                            ("segmented", "stress", {"objects": 128})):
        dev, batch = setups_on_card(name, ms, w, h, **kw)
        kernel = getattr(tr, f"raster_{route}_{sampling}")
        tables = tables_for(route, batch)
        binned = binned_for(route, batch, w, h)
        before = kernel.launches
        pb, db = kernel(*binned, *tables, dev["textures"], width=w, height=h,
                        background=BG)
        assert kernel.launches == before + 1
        for b in range(3):
            ps, ds = kernel(*(t[b] for t in (*binned, *tables)),
                            dev["textures"], width=w, height=h, background=BG)
            assert torch.equal(pb[b], ps) and torch.equal(db[b], ds)
        config = port.RenderConfig(sampling=sampling)
        scene = SCENES[name](seed=0, **kw)
        pg, dg = port.Renderer(scene, config, device="cuda").render_batch(ms, w, h)
        on_cpu = port.Renderer(scene, config, device="cpu")
        for b, m in enumerate(ms):
            pc, dc = on_cpu.render(m, w, h)
            np.testing.assert_array_equal(pg[b].cpu().numpy().view(np.uint32), pc)
            np.testing.assert_array_equal(dg[b].cpu().numpy(), dc)


def binned_for(route, setup, w, h, y_offset=0):
    """The route's binner outputs in its kernel's argument order."""
    if route == "flat":
        return tr.bin_triangles(setup, width=w, height=h, tile_h=tr.TILE_H,
                                tile_w=tr.TILE_W, y_offset=y_offset)[::-1]
    return tr.bin_segments(setup, width=w, height=h, y_offset=y_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_tracking_kernels_match_plain_on_cuda(sampling):
    """Each kernel's tracking form (gids 2 * 500 + slot) against its plain
    version on the card, bit for bit on pixels, depth and gids, single
    frames and a B = 3 batch; its pixels and depth equal the non-tracking
    launch's."""
    need_card()
    w, h = RAGGED
    for route, name, kw in (("flat", "default", {}),
                            ("segmented", "stress", {"objects": 128})):
        dev, batch = setups_on_card(name, flight(12)[::4], w, h, **kw)
        kernel = getattr(tr, f"raster_{route}_{sampling}")
        plain = getattr(tr, f"raster_{route}_{sampling}_plain")
        s = batch["live"].shape[-1]
        gids = 1000 + torch.arange(s, dtype=torch.int32, device="cuda")
        for setup in [{k: v[b] for k, v in batch.items()} for b in range(3)] + [batch]:
            binned = binned_for(route, setup, w, h)
            args = (*binned, *tables_for(route, setup, gids), dev["textures"])
            kw_out = dict(width=w, height=h, background=BG)
            before = (kernel.launches, kernel.launches_ids)
            pk, dk, gk = kernel(*args, track_ids=True, **kw_out)
            pp, dp, gp = plain(*args, track_ids=True, **kw_out)
            pn, dn = kernel(*args, **kw_out)
            torch.cuda.synchronize()
            assert (kernel.launches, kernel.launches_ids) == (before[0] + 1,
                                                              before[1] + 1)
            assert torch.equal(pk, pp) and torch.equal(dk, dp) and torch.equal(gk, gp)
            assert torch.equal(pk, pn) and torch.equal(dk, dn)
            drawn = dk > 0
            assert bool(drawn.any()) and bool((gk[~drawn] == -1).all())
            assert bool((gk[drawn] >= 1000).all())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flat", "segmented"])
def test_stitched_bands_equal_full_frame_on_cuda(route):
    """Bands of 2, 4 and 8 (ragged: 217 rows) at y0 > 0 through each
    kernel's launch with y_offset, stacked, give the full frame bit for
    bit."""
    need_card()
    w, h = RAGGED
    name, kw = (("default", {}) if route == "flat"
                else ("stress", {"objects": 128}))
    dev, batch = setups_on_card(name, flight(12)[::4], w, h, **kw)
    setup = {k: v[1] for k, v in batch.items()}
    tables = tables_for(route, setup)
    for sampling in ("nearest", "bilinear"):
        kernel = getattr(tr, f"raster_{route}_{sampling}")
        full = kernel(*binned_for(route, setup, w, h), *tables,
                      dev["textures"], width=w, height=h, background=BG)
        for n in (2, 4, 8):
            edges = [h * i // n for i in range(n + 1)]
            parts = [kernel(*binned_for(route, setup, w, y1 - y0, y0), *tables,
                            dev["textures"], width=w, height=y1 - y0,
                            background=BG, y_offset=y0)
                     for y0, y1 in zip(edges, edges[1:])]
            for got, want in zip((torch.cat(p) for p in zip(*parts)), full):
                assert torch.equal(got, want), (sampling, n)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_segmented_lists_and_records_match_plain_on_cuda(sampling):
    """The segmented kernel's three lists and staged records against its
    plain version on the card, bit for bit, pixels, depth and gids: a ragged
    frame, a band at y_offset > 0, a B = 4 batch, untracked and tracked, at
    G = 1 (every wide slot on the residual list, as before super-tiles), 2,
    the default and 16, and at K = 4 (long super-tile lists)."""
    need_card()
    w, h = RAGGED
    dev, batch = setups_on_card("stress", flight(16)[::4], w, h, objects=128)
    kernel = getattr(tr, f"raster_segmented_{sampling}")
    plain = getattr(tr, f"raster_segmented_{sampling}_plain")
    s = batch["live"].shape[-1]
    gids = 2000 + torch.arange(s, dtype=torch.int32, device="cuda")
    one = {k: v[0] for k, v in batch.items()}
    cases = [(one, 0, h, k, g) for k, g in ((tr.SEG_K, 1), (tr.SEG_K, 2),
                                            (tr.SEG_K, tr.SEG_G),
                                            (tr.SEG_K, 16), (4, tr.SEG_G))]
    cases += [(one, 61, 100, tr.SEG_K, tr.SEG_G), (batch, 0, h, tr.SEG_K, tr.SEG_G),
              (batch, 61, 100, 4, 2)]
    for setup, y0, bh, k, g in cases:
        binned = tr.bin_segments(setup, width=w, height=bh, k=k, g=g, y_offset=y0)
        for track in (False, True):
            args = (*binned, *tables_for("segmented", setup,
                                         gids if track else None),
                    dev["textures"])
            kw = dict(width=w, height=bh, background=BG, g=g, y_offset=y0,
                      track_ids=track)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (y0, bh, k, g, track)
            assert bool((got[1] > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_segmented_residual_filter_matches_plain_on_cuda(sampling):
    """A residual broadband list longer than a chunk, which the segmented
    kernel filters by bbox before copying records, against the plain
    version on the card, bit for bit, untracked and tracked: the stress
    field at K = 1, G = 1 (hundreds of residual slots, a few hits a tile),
    and the default scene's slots repeated 300 times (30,600 slots, equal
    depths tied to the smaller slot) at K = 1, G = 1, where some tile's hits
    pass the kernel's 768 before the rest is copied unfiltered."""
    need_card()
    kernel = getattr(tr, f"raster_segmented_{sampling}")
    plain = getattr(tr, f"raster_segmented_{sampling}_plain")
    m = torch.as_tensor(flight(1)[0], device="cuda")
    stress = scene_to_device(SCENES["stress"](seed=0, objects=128), "cuda")
    default = scene_to_device(SCENES["default"](seed=0), "cuda")
    one = build_setup(default, m, width=W, height=H, config=port.DEFAULT_CONFIG)
    cases = [(stress, build_setup(stress, m, width=RAGGED[0], height=RAGGED[1],
                                  config=port.DEFAULT_CONFIG), *RAGGED),
             (default, {k: torch.cat([v] * 300) for k, v in one.items()}, W, H)]
    most = []
    for dev, setup, w, h in cases:
        binned = tr.bin_segments(setup, width=w, height=h, k=1, g=1)
        wide = int(binned[4][0])
        assert wide > 128
        box = binned[5][:wide].cpu().numpy()
        ntx, nty = -(-w // tr.TILE_W), -(-h // tr.TILE_H)
        tx, ty = np.arange(ntx * nty) % ntx, np.arange(ntx * nty) // ntx
        most.append(int(((box[:, 0, None] // tr.TILE_W <= tx)
                         & (box[:, 1, None] // tr.TILE_W >= tx)
                         & (box[:, 2, None] // tr.TILE_H <= ty)
                         & (box[:, 3, None] // tr.TILE_H >= ty)).sum(0).max()))
        s = setup["live"].shape[-1]
        gids = 2000 + torch.arange(s, dtype=torch.int32, device="cuda")
        for track in (False, True):
            args = (*binned, *tables_for("segmented", setup,
                                         gids if track else None),
                    dev["textures"])
            kw = dict(width=w, height=h, background=BG, g=1, track_ids=track)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (s, track)
            assert bool((got[1] > 0).any())
    assert most[0] < 768 < most[1]


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_flat_kernel_edges_match_plain_on_cuda(sampling):
    """The flat kernel (listed slots' table columns in shared memory, listed
    slots culled per tile, several tiles a block) against its plain version
    on the card, bit for bit, pixels, depth and gids, untracked and tracked,
    each case a batch whole and on a band at y0 > 0: the default scene (S =
    102, not a multiple of 4), with tiles whose listed slots are all culled;
    its slots with the first 23 again (S = 125, and depth ties the earlier
    slot must win); a B = 4 batch at the ragged 333x217 (a block's tiles lie
    in one frame); the band on that ragged
    width; and the live slots repeated, each bbox the whole frame, so that
    a block culls hundreds of listed slots in several rounds. More than 125
    slots are refused."""
    need_card()
    kernel = getattr(tr, f"raster_flat_{sampling}")
    plain = getattr(tr, f"raster_flat_{sampling}_plain")
    w, h = W, H
    dev, two = setups_on_card("default", flight(8)[::4], w, h)
    one = {k: v[0] for k, v in two.items()}
    counts, ids = binned_for("flat", one, w, h)
    keep = tr.tile_cull_plain(counts, ids, *tables_for("flat", one), width=w,
                              height=h)
    assert bool(((counts[:, 0] > 0) & ~keep.any(dim=1)).any())
    dup = {k: torch.cat([v, v[:, :23]], dim=1) for k, v in two.items()}
    _, four = setups_on_card("default", flight(16)[::4], *RAGGED)
    live = torch.nonzero(one["live"])[:, 0]
    wide = {k: v[live.repeat(tr.FLAT_MAX_SLOTS // live.numel())]
            for k, v in one.items()}
    wide.update(xmin=torch.zeros_like(wide["xmin"]),
                xmax=torch.full_like(wide["xmax"], w - 1),
                ymin=torch.zeros_like(wide["ymin"]),
                ymax=torch.full_like(wide["ymax"], h - 1))
    assert int(wide["live"].sum()) > 64      # > 256 listed in 4 tiles
    cases = [(two, w, h), (dup, w, h), (four, *RAGGED), (wide, w, h)]
    for setup, cw, ch in cases:
        s = setup["live"].shape[-1]
        gids = 1000 + torch.arange(s, dtype=torch.int32, device="cuda")
        for track in (False, True):
            for y0, rows in ((0, ch), (61, 100)):
                args = (*binned_for("flat", setup, cw, rows, y0),
                        *tables_for("flat", setup, gids if track else None),
                        dev["textures"])
                kw = dict(width=cw, height=rows, background=BG, y_offset=y0,
                          track_ids=track)
                got, want = kernel(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (s, cw, y0, track)
                if track and s == 125 and y0 == 0:
                    assert bool(((want[2] >= 1000) & (want[2] < 1023)).any())
    big = {k: torch.cat([v, v[:, :24]], dim=1) for k, v in two.items()}
    with pytest.raises(ValueError):
        kernel(*binned_for("flat", big, w, h), *tables_for("flat", big),
               dev["textures"], width=w, height=h, background=BG)


PROBE_ITERS = (1, 3, 64, 130)   # and each tool's full ITERS
# The probes whose iterations run in chunks also at 0 and across the chunk
# length of small counts (tools/_probe.py chunk_plan).
CHUNKED_ITERS = (0, _probe.MIN_CHUNK, _probe.MIN_CHUNK + 1)


def eager(r, ms, w, h):
    """The renderer's frames of the poses ``ms`` launched eagerly."""
    return trenderer.render_frames(
        r.dev, torch.as_tensor(np.stack(ms), device="cuda"), width=w,
        height=h, config=r.config)


def assert_equal_on_card(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "stress"])
def test_captured_frames_equal_eager_frames_on_cuda(name):
    """render_device and render_batch replay a CUDA graph captured once per
    (W, H, B): bit-equal to the eager frames, on the flat route (default)
    and the segmented one (stress_scene(objects=128)), nearest and
    bilinear."""
    need_card()
    kw = dict(objects=128) if name == "stress" else {}
    poses = flight(6)
    for config in (port.DEFAULT_CONFIG, port.RenderConfig(sampling="bilinear")):
        r = port.Renderer(SCENES[name](seed=0, **kw), config, device="cuda")
        for w, h in ((W, H), RAGGED):
            for m in poses:
                pix, depth = r.render_device(m, w, h)
                want = eager(r, [m], w, h)
                assert_equal_on_card((pix, depth), (want[0][0], want[1][0]))
            assert_equal_on_card(r.render_batch(np.stack(poses[:3]), w, h),
                                 eager(r, poses[:3], w, h))
        assert r.graphs.captures == 4           # (W, H) x B = 1, 3
        assert r.graphs.replays == 2 * (len(poses) + 1)


@pytest.mark.cuda
def test_bucketed_frames_equal_exact_frames_on_cuda():
    """render(..., bucketed=True) replays one graph per bucket; the crop
    equals the exact-size frame bit for bit, flat and segmented."""
    need_card()
    sizes = [(320, 240), (300, 200), (333, 217), (512, 384), (1366, 768)]
    for name, kw in (("default", {}), ("stress", dict(objects=128))):
        r = port.Renderer(SCENES[name](seed=0, **kw), device="cuda")
        for m in flight(6)[::5]:
            for w, h in sizes:
                pix, depth = r.render(m, w, h, bucketed=True)
                want = eager(r, [m], w, h)
                np.testing.assert_array_equal(
                    pix, want[0][0].cpu().numpy().view(np.uint32))
                np.testing.assert_array_equal(depth, want[1][0].cpu().numpy())
        buckets = {trenderer.bucket_dims(w, h) for w, h in sizes}
        assert r.graphs.captures == len(buckets) == 3


@pytest.mark.cuda
def test_replay_follows_update_scene_on_cuda():
    """update_scene writes into the scene's tensors in place: the graph
    captured before it renders the moved scene, bit-equal to a fresh
    renderer's eager frame on that scene."""
    need_card()
    scene = SCENES["tetrahedron"](seed=0)
    r = port.Renderer(scene, device="cuda")
    m = flight(1)[0]
    before, _ = r.render_device(m, W, H)
    moved = scene.vertices.copy()
    moved[:, 0] += 2.0
    r.update_scene(vertices=moved)
    pix, depth = r.render_device(m, W, H)
    assert r.graphs.captures == 1 and r.graphs.replays == 2
    assert not torch.equal(pix, before)
    fresh = port.Renderer(dataclasses.replace(scene, vertices=moved),
                          device="cuda")
    assert_equal_on_card((pix, depth),
                         tuple(x[0] for x in eager(fresh, [m], W, H)))
    with pytest.raises(ValueError, match="shape"):
        r.update_scene(vertices=moved[:2])


@pytest.mark.cuda
def test_result_survives_the_next_call_on_cuda():
    """What render_device and render_batch return is the caller's: the
    next replay of the same graph does not overwrite it."""
    need_card()
    r = port.Renderer(SCENES["default"](seed=0), device="cuda")
    poses = flight(8)
    held = [r.render_device(m, W, H) for m in poses[:4]]
    batches = [r.render_batch(np.stack(poses[i:i + 2]), W, H)
               for i in (4, 6)]
    for m, got in zip(poses[:4], held):
        assert_equal_on_card(got, tuple(x[0] for x in eager(r, [m], W, H)))
    for i, got in zip((4, 6), batches):
        assert_equal_on_card(got, eager(r, poses[i:i + 2], W, H))
    assert not torch.equal(held[0][0], held[3][0])
    assert r.graphs.captures == 2 and r.graphs.replays == 6


@pytest.mark.cuda
def test_capture_counters_over_a_resize_sweep_on_cuda():
    """tests/test_resize.py's 50-step drag-resize, 300x200 -> 790x445:
    bucketed, at most 4 captures and one replay a step; at exact sizes one
    capture a size, and a size seen again replays."""
    need_card()
    r = port.Renderer(SCENES["tetrahedron"](seed=0), device="cuda")
    m = flight(1)[0]
    for i in range(50):
        w, h = 300 + 10 * i, 200 + 5 * i
        pix, _ = r.render(m, w, h, bucketed=True)
        assert pix.shape == (h, w)
    assert 1 <= r.graphs.captures <= 4 and r.graphs.replays == 50
    assert all(k[0] == "bucket" for k in r.graphs.captured)
    exact = port.Renderer(SCENES["tetrahedron"](seed=0), device="cuda")
    for w, h in ((300, 200), (310, 205), (300, 200)):
        exact.render(m, w, h)
    assert exact.graphs.captures == 2 and exact.graphs.replays == 3
    for stats in exact.graphs.captured.values():
        assert stats["capture_ms"] > 0 and stats["reserved_bytes"] >= 0


# Renders a frame whose capture is made to fail: a scalar read (a copy to
# the host and a synchronisation, which a capture forbids) is slipped into
# the frame's rasterizer while a capture is under way. A failed capture can
# leave the CUDA context unusable, hence a process of its own.
_FAILED_CAPTURE_RUN = """
import torch
import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch import renderer
from swift3drenderer_tpu_torch.models import SCENES
rasterize = renderer.rasterize

def reads_a_scalar(setup, *args, **kw):
    if torch.cuda.is_current_stream_capturing():
        int(setup["live"].sum())
    return rasterize(setup, *args, **kw)

renderer.rasterize = reads_a_scalar
r = port.Renderer(SCENES["tetrahedron"](seed=0), device="cuda")
try:
    r.render_device(port.Camera().matrix, 64, 48)
except RuntimeError as e:
    print("raised", r.graphs.captures, r.graphs.replays, len(r.graphs.captured),
          flush=True)
else:
    print("rendered", flush=True)
"""


@pytest.mark.cuda
def test_failed_capture_raises_on_cuda():
    """A capture that fails raises out of render_device; nothing is kept
    or replayed, and no eager frame is returned in its place."""
    need_card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE_RUN],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.stdout.split()[-4:] == ["raised", "0", "0", "0"], (
        run.stdout[-2000:] + run.stderr[-3000:])


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["gather2d", "packed_fetch", "fetch_microbench"])
def test_fetch_probes_match_plain_on_cuda(probe):
    """Every mode of each fetch probe's kernel against its plain version on
    the card, bit for bit, at small counts, at 0 and across the chunk length
    (all three run their iterations in chunks) and the tool's full ITERS;
    each call is one launch."""
    need_card()
    if probe == "gather2d":
        wrapper, plain, full = pg2.probe_gather2d, pg2.probe_gather2d_plain, pg2.ITERS
        data = pg2.inputs("cuda")
        cases = [(m, *data[m], ()) for m in pg2.MODES]
    elif probe == "packed_fetch":
        wrapper, plain, full = (ppf.probe_packed_fetch,
                                ppf.probe_packed_fetch_plain, ppf.ITERS)
        data = ppf.inputs("cuda")
        cases = [(m, *data[m], (mix,)) for m in ppf.MODES for mix in (0, 127)]
    else:
        wrapper, plain, full = (pfm.fetch_microbench,
                                pfm.fetch_microbench_plain, pfm.ITERS)
        data = pfm.inputs("cuda")
        cases = [(m, *data, ()) for m in pfm.MODES]
    counts = PROBE_ITERS + (full,) + CHUNKED_ITERS
    for mode, a, b, c, extra in cases:
        for iters in counts:
            before = wrapper.launches
            got = wrapper(mode, a, b, c, *extra, iters)
            want = plain(mode, a, b, c, *extra, iters)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert torch.equal(got, want), (mode, extra, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["gather2d", "fetch_microbench", "packed_fetch"])
def test_chunked_probes_capture_in_a_graph_on_cuda(probe):
    """One call of each mode of the chunked probes (the output's zeroing and
    the chunked launch) is captured in a CUDA graph, counted as one launch,
    and each replay gives the plain version's bits again."""
    need_card()
    if probe == "gather2d":
        wrapper, plain, data = (pg2.probe_gather2d, pg2.probe_gather2d_plain,
                                pg2.inputs("cuda"))
        cases = [(m, *data[m]) for m in pg2.MODES]
    elif probe == "packed_fetch":
        wrapper, plain, data = (ppf.probe_packed_fetch,
                                ppf.probe_packed_fetch_plain, ppf.inputs("cuda"))
        cases = [(m, *data[m], ppf.TIMED_MIX) for m in ppf.MODES]
    else:
        wrapper, plain, data = (pfm.fetch_microbench,
                                pfm.fetch_microbench_plain, pfm.inputs("cuda"))
        cases = [(m, *data) for m in pfm.MODES]
    iters = _probe.MIN_CHUNK * 3 + 1
    for args in cases:
        wrapper(*args, iters)   # loads the library outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = wrapper.launches
        with torch.cuda.graph(graph):
            got = wrapper(*args, iters)
        assert wrapper.launches == before + 1
        want = plain(*args, iters)
        for _ in range(2):
            got.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want), args[0]


@pytest.mark.cuda
def test_dynamic_grid_reads_its_count_on_cuda():
    """The chunk count lives on the card: each count, clamped to [0, NCMAX],
    gives the plain version's and the tool's sums."""
    need_card()
    tab, hbm = pdg.inputs("cuda")
    for nc in (-1, 0) + pdg.CHUNKS + (9,):
        count = torch.tensor(nc, dtype=torch.int32, device="cuda")
        got = pdg.probe_dynamic_grid(tab, hbm, count)
        assert torch.equal(got, pdg.probe_dynamic_grid_plain(tab, hbm, count)), nc
        want = pdg.expected(tab.cpu().numpy(), hbm.cpu().numpy(),
                            min(max(nc, 0), pdg.NCMAX))
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_dynamic_grid_replays_a_count_rewritten_in_place_on_cuda():
    """One call captured in a CUDA graph, then the count tensor rewritten in
    place between replays: each replay runs the loop the count on the card
    says, with no host read, and equals the plain version (7 clamped)."""
    need_card()
    tab, hbm = pdg.inputs("cuda")
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    pdg.probe_dynamic_grid(tab, hbm, count)   # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = pdg.probe_dynamic_grid.launches
    with torch.cuda.graph(graph):
        got = pdg.probe_dynamic_grid(tab, hbm, count)
    assert pdg.probe_dynamic_grid.launches == before + 1
    for nc in (0, 1, 2, 3, 4, 7, 2):
        count.fill_(nc)
        got.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, pdg.probe_dynamic_grid_plain(tab, hbm, count)), nc
        want = pdg.expected(tab.cpu().numpy(), hbm.cpu().numpy(),
                            min(nc, pdg.NCMAX))
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_app_flight_on_cuda_equals_cpu():
    """run_headless on the card: every frame of a scripted flight (exact
    and bucketed) equals the CPU loop's frame, the first capture replayed
    for every later frame, on the cuda backend."""
    from swift3drenderer_tpu_torch.app import FrameLoop, scripted_inputs

    need_card()
    scene = SCENES["default"](seed=0)
    for bucketed in (False, True):
        card = FrameLoop(scene, W, H, device="cuda", bucketed=bucketed)
        cpu = FrameLoop(scene, W, H, device="cpu", bucketed=bucketed)
        for inp in scripted_inputs("6:w;6:w mx2", 12):
            np.testing.assert_array_equal(card.step(inp), cpu.step(inp))
        assert card.renderer.graphs.captures == 1
        assert card.renderer.graphs.replays == 12
        assert card.renderer.backend == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_xla_backend_on_cuda_equals_cpu(sampling):
    """Renderer(backend="xla") on the card against the CPU, bit for bit:
    single frames (captured), a batch, a bucketed frame; and within the
    port's bound of the "cuda" backend."""
    need_card()
    cfg = port.RenderConfig(sampling=sampling)
    scene = SCENES["default"](seed=0)
    card = port.Renderer(scene, cfg, device="cuda", backend="xla")
    cpu = port.Renderer(scene, cfg, device="cpu", backend="xla")
    kernels = port.Renderer(scene, cfg, device="cuda")
    poses = flight(3)
    for m in poses:
        pg, dg = card.render(m, W, H)
        pc, dc = cpu.render(m, W, H)
        np.testing.assert_array_equal(pg, pc)
        np.testing.assert_array_equal(dg, dc)
        pk, dk = kernels.render(m, W, H)
        diff = np.abs(np.stack([(pk.astype(np.int64) >> s) & 255
                                for s in (16, 8, 0)])
                      - np.stack([(pg.astype(np.int64) >> s) & 255
                                  for s in (16, 8, 0)])).max(0)
        assert (diff > 1).mean() < 5e-4
        np.testing.assert_array_equal(dk > 0, dg > 0)
    bg, bd = card.render_batch(np.stack(poses), *RAGGED)
    bc, bdc = cpu.render_batch(np.stack(poses), *RAGGED)
    assert torch.equal(bg.cpu(), bc) and torch.equal(bd.cpu(), bdc)
    pb, db = card.render(poses[1], *RAGGED, bucketed=True)
    np.testing.assert_array_equal(pb, bc[1].numpy().view(np.uint32))
    np.testing.assert_array_equal(db, bdc[1].numpy())


GRID = (2, 4)             # render_batch_sharded's emulated (frame, fb) grid


@pytest.mark.cuda
def test_sharded_render_batch_replays_on_cuda():
    """ShardedRenderer.render_batch on an NCCL world of one rank replays
    its rank's block from one graph per (W, H, B): bit-equal to the eager
    block and to Renderer.render_batch, one capture then replays, and what
    it returns survives the next call."""
    import torch.distributed as dist
    from swift3drenderer_tpu_torch.parallel import (
        ShardedRenderer, make_mesh, render_batch_sharded)

    need_card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        scene = SCENES["default"](seed=0)
        sr = ShardedRenderer(scene, mesh=make_mesh(1, 1, device="cuda"),
                             device="cuda")
        r = port.Renderer(scene, device="cuda")
        poses = flight(8)
        held = []
        for i in (0, 4):
            ms = np.stack(poses[i:i + 4])
            got = sr.render_batch(ms, W, H)
            held.append((got, ms))
            block = render_batch_sharded(
                sr.dev, torch.as_tensor(ms, device="cuda"), width=W,
                height=H, mesh=sr.mesh)
            assert_equal_on_card(got, block)
            assert_equal_on_card(got, r.render_batch(ms, W, H))
        assert sr.graphs.captures == 1 and sr.graphs.replays == 2
        assert_equal_on_card(held[0][0], eager(r, list(held[0][1]), W, H))
        sr.render_batch(np.stack(poses[:2]), W, H)
        assert sr.graphs.captures == 2
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "stress"])
def test_grid_blocks_replay_equal_eager_blocks_on_cuda(name):
    """Each of the eight blocks of the emulated 2 x 4 grid (a mesh of one
    rank that holds no group), replayed from its renderer's graph, equals
    its eager render_batch_sharded block, on the flat route (default) and
    the segmented one (stress_scene(objects=128))."""
    from swift3drenderer_tpu_torch.parallel import (
        Mesh, ShardedRenderer, render_batch_sharded)

    need_card()
    kw = dict(objects=128) if name == "stress" else {}
    scene = SCENES[name](seed=0, **kw)
    dev = torch.device("cuda", torch.cuda.current_device())
    ms = np.stack(flight(4))
    for rank in range(GRID[0] * GRID[1]):
        sr = ShardedRenderer(scene, mesh=Mesh(*GRID, rank, dev, None, None,
                                              None), device="cuda")
        want = render_batch_sharded(sr.dev, torch.as_tensor(ms, device=dev),
                                    width=W, height=H, mesh=sr.mesh)
        for _ in range(2):
            got = sr._block(ms, W, H)
            assert_equal_on_card(got, want)
        assert tuple(got[0].shape) == (4 // GRID[0], H // GRID[1], W)
        assert sr.graphs.captures == 1 and sr.graphs.replays == 2


@pytest.mark.cuda
def test_scene_sharded_replays_on_cuda():
    """render_scene_sharded on an NCCL world of one rank replays its rank's
    range from one graph per key (one capture, then replays), each call
    bit-equal to render_device and to the eager range, a result held from
    the first call unchanged after the later ones, on the flat route
    (default) and the segmented one (stress_scene(objects=128)); and
    ShardedRenderer(backend="xla") replays bit-equal to
    Renderer(backend="xla").render_batch."""
    import torch.distributed as dist
    from swift3drenderer_tpu_torch.parallel import (
        ShardedRenderer, make_mesh, render_scene_sharded, sharding)

    need_card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    cache = render_scene_sharded.graphs
    try:
        mesh = make_mesh(1, 1, device="cuda")
        poses = flight(3)
        for name, kw in (("default", {}), ("stress", dict(objects=128))):
            r = port.Renderer(SCENES[name](seed=0, **kw), device="cuda")
            captures, replays = cache.captures, cache.replays
            held = []
            for m in poses:
                mt = torch.as_tensor(m, device="cuda")
                got = render_scene_sharded(r.dev, mt, width=W, height=H,
                                           mesh=mesh)
                held.append((got, m))
                assert_equal_on_card(got, r.render_device(m, W, H))
                ref = sharding._scene_range(
                    r.dev, mt, width=W, height=H, config=r.config, mesh=mesh,
                    backend="cuda")
                assert_equal_on_card(got, ref[:2])
            assert cache.captures - captures == 1
            assert cache.replays - replays == len(poses)
            assert not torch.equal(held[0][0][0], held[-1][0][0])
            assert_equal_on_card(held[0][0], r.render_device(poses[0], W, H))
        scene = SCENES["default"](seed=0)
        sr = ShardedRenderer(scene, mesh=mesh, device="cuda", backend="xla")
        want = port.Renderer(scene, device="cuda", backend="xla")
        for i in (0, 4):
            ms = np.stack(flight(8)[i:i + 4])
            assert_equal_on_card(sr.render_batch(ms, W, H),
                                 want.render_batch(ms, W, H))
        assert sr.graphs.captures == 1 and sr.graphs.replays == 2
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "stress"])
def test_emulated_scene_ranks_replay_equal_eager_ranges_on_cuda(name):
    """Each rank's range of emulated 2- and 4-rank meshes (a Mesh of one
    rank that holds no group), replayed from render_scene_sharded's graph
    cache, equals its eager render_range bit for bit; merged, the replays
    give the single frame."""
    from swift3drenderer_tpu_torch.parallel import (
        Mesh, merge_depth_gid, render_scene_sharded, sharding)
    from swift3drenderer_tpu_torch.renderer import render_range

    need_card()
    kw = dict(objects=128) if name == "stress" else {}
    r = port.Renderer(SCENES[name](seed=0, **kw), device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    m = flight(2)[1]
    mt = torch.as_tensor(m, device=dev)
    t = r.dev["vert_c"].shape[0]
    cache = render_scene_sharded.graphs
    for n in (2, 4):
        acc = None
        for rank in range(n):
            mesh = Mesh(1, n, rank, dev, None, None, None)
            local = -(-t // n)
            want = render_range(r.dev, mt, lo=rank * local, count=local,
                                width=W, height=H, config=r.config)
            captures = cache.captures
            for _ in range(2):
                packed, graphed = sharding._packed_range(
                    r.dev, mt, width=W, height=H, config=r.config,
                    mesh=mesh, backend="cuda")
                assert graphed
                assert_equal_on_card(sharding._unpack(packed), want)
            assert cache.captures - captures == 1
            got = tuple(p.clone() for p in sharding._unpack(packed))
            acc = got if acc is None else merge_depth_gid(*acc, *got)
        assert_equal_on_card(acc[:2], r.render_device(m, W, H))


@pytest.mark.cuda
def test_dryrun_multichip_on_cuda():
    """dryrun_multichip on every card of the machine (one NCCL rank a card,
    spawned): both backends' batches and composites bit-equal to the
    single-device frames on each rank."""
    from swift3drenderer_tpu_torch.entry import dryrun_multichip

    need_card()
    n = torch.cuda.device_count()
    out = dryrun_multichip(n)
    assert len(out["launches"]) == n and out["device"] == "cuda"
    assert all(sum(x.values()) > 0 for x in out["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flat", "segmented"])
def test_timing_forms_match_plain_on_cuda(route):
    """Each kernel's ``"vis"`` and ``"shade"`` forms, both samplings,
    untracked and tracked, against their plain versions bit for bit; each
    launch counted in its wrapper's ``.launches_vis`` or
    ``.launches_shade`` alone."""
    need_card()
    scene = (SCENES["default"](seed=0) if route == "flat"
             else SCENES["stress"](seed=0, objects=128))
    dev = scene_to_device(scene, "cuda")
    setup = build_setup(dev, torch.as_tensor(flight(3)[2], device="cuda"),
                        width=W, height=H, config=port.DEFAULT_CONFIG)
    gids = 1000 + torch.arange(setup["live"].shape[-1], dtype=torch.int32,
                               device="cuda")
    for sampling in tr.SAMPLINGS:
        kernel = getattr(tr, f"raster_{route}_{sampling}")
        plain = getattr(tr, f"raster_{route}_{sampling}_plain")
        for track in (False, True):
            trf, tri = tr.pack_setup_tables(setup, gids if track else None)
            if route == "flat":
                ids, counts = tr.bin_triangles(setup, width=W, height=H,
                                               tile_h=tr.TILE_H,
                                               tile_w=tr.TILE_W)
                args = (counts, ids, trf, tri)
            else:
                args = (*tr.bin_segments(setup, width=W, height=H), trf, tri,
                        tr.pack_slot_records(setup))
            for phases in ("vis", "shade"):
                kw = dict(width=W, height=H, background=BG, track_ids=track,
                          phases=phases)
                before = (kernel.launches, kernel.launches_ids,
                          kernel.launches_vis, kernel.launches_shade)
                got = kernel(*args, dev["textures"], **kw)
                torch.cuda.synchronize()
                want = plain(*args, dev["textures"], **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                vis = phases == "vis"
                assert (kernel.launches, kernel.launches_ids,
                        kernel.launches_vis, kernel.launches_shade) == (
                    before[0], before[1], before[2] + vis,
                    before[3] + (not vis))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "stress"])
def test_stage_probe_replays_the_frame_on_cuda(name):
    """``perf_probe.Stages`` on the card: the full stage's replayed graph is
    ``Renderer.render_device``'s frame, the grid stage the background; the
    probe gives every stage, each >= 0."""
    from swift3drenderer_tpu_torch.tools import perf_probe
    need_card()
    scene = (SCENES["default"](seed=0) if name == "default"
             else SCENES["stress"](seed=0, objects=128))
    stages = perf_probe.Stages(scene, W, H, device="cuda")
    r = port.Renderer(scene, device="cuda")
    for m in flight(4)[1:]:
        pix, depth = (t.clone() for t in stages.run("full", m))
        want = r.render_device(m, W, H)
        assert torch.equal(pix, want[0]) and torch.equal(depth, want[1])
        grid = stages.run("grid", m)
        assert bool((grid[0] == BG).all()) and bool((grid[1] == 0).all())
    ms = stages.times(perf_probe.PROBE_STAGES, perf_probe.flight(3))
    assert set(ms) == set(perf_probe.PROBE_STAGES)
    assert all(v >= 0 for v in ms.values())
