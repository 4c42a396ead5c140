"""The port's CUDA kernels on the card: ``raster_flat_nearest``,
``raster_segmented_nearest``, ``raster_flat_bilinear`` and
``raster_segmented_bilinear`` and their tracking forms against their plain
PyTorch versions, batched launches against single ones, stitched bands
against full frames, the segmented kernels' super-tile lists, staged
slot records and residual filter at several K and G, and the CUDA renderer (single frames and
``render_batch``) against the CPU one, on the default scene and on a stress
field (3,078 slots, the segmented path); and the probes of
``swift3drenderer_tpu_torch.tools`` against their plain versions.

Each test needs a CUDA card (and nvcc, which builds the kernel at first use)
and skips without one. The file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed, without tests/conftest.py (which imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.models import SCENES
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.renderer import build_setup, scene_to_device
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
    the card, and the same frames as the CPU renderer, bit for bit."""
    need_card()
    scene = SCENES["stress"](seed=0, objects=128)
    on_card = port.Renderer(scene, device="cuda")
    on_cpu = port.Renderer(scene, device="cpu")
    for m in flight(12)[::3]:
        for w, h in ((W, H), RAGGED):
            flat, seg = (tr.raster_flat_nearest.launches,
                         tr.raster_segmented_nearest.launches)
            pg, dg = on_card.render(m, w, h)
            assert tr.raster_segmented_nearest.launches == seg + 1
            assert tr.raster_flat_nearest.launches == flat
            pc, dc = on_cpu.render(m, w, h)
            np.testing.assert_array_equal(pg, pc)
            np.testing.assert_array_equal(dg, dc)


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


PROBE_ITERS = (1, 3, 64, 130)   # and each tool's full ITERS


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["gather2d", "packed_fetch", "fetch_microbench"])
def test_fetch_probes_match_plain_on_cuda(probe):
    """Every mode of each fetch probe's kernel against its plain version on
    the card, bit for bit, at small counts and the tool's full ITERS; each
    call is one launch."""
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
    for mode, a, b, c, extra in cases:
        for iters in PROBE_ITERS + (full,):
            before = wrapper.launches
            got = wrapper(mode, a, b, c, *extra, iters)
            want = plain(mode, a, b, c, *extra, iters)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert torch.equal(got, want), (mode, extra, iters)


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
