"""The port's segmented front-end (``bin_segments``) and the plain version of
``raster_segmented_nearest`` held against the JAX package on CPU.

The JAX side runs as tests/test_pallas.py runs it: the Pallas kernel in
interpret mode, here with 8-row tiles (winners do not depend on the tiling,
and the short tiles keep the interpret-mode compile to seconds). Both sides
rasterize the same setup table, made by the JAX front-end. Bounds, against the
JAX output: winners equal on >= 99.95 % of pixels where the JAX side exposes
them, else equal drawn-pixel sets; pixel mismatch < 5e-4 at tol 1 (the bound
test_pallas_matches_xla keeps between the JAX package's own two paths); depth
rtol 1e-4 where both are drawn; each side within 0.2 % of golden.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import stress_scene
from swift3drenderer_tpu.ops import raster_pallas as jr
from swift3drenderer_tpu.renderer import build_setup, scene_to_device
import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch import kernels
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.renderer import build_setup as port_build_setup
from swift3drenderer_tpu_torch.renderer import scene_to_device as port_to_device
from swift3drenderer_tpu_torch.tools import seg_variants

from conftest import pixel_mismatch_fraction

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

BG = DEFAULT_CONFIG.background_packed


def to_torch(setup):
    return {k: torch.from_numpy(np.array(v)) for k, v in setup.items()}


def jax_touch_lists(arrays, live, w, h):
    """Each tile's touching slots at the port's tile, from the JAX package's
    flat binner: a list of ascending arrays, tile-major."""
    sj = {k: jnp.asarray(v) for k, v in arrays.items()}
    sj["live"] = jnp.asarray(live)
    ids, counts = jr.bin_triangles(sj, width=w, height=h, tile_h=tr.TILE_H,
                                   tile_w=tr.TILE_W)
    ids, counts = np.asarray(ids), np.asarray(counts)[:, 0]
    return [ids[t, :counts[t]] for t in range(ids.shape[0])]


def super_tile_bbox(arrays, g, y0=0, nty=None):
    """Each slot's tile bbox and super-tile bbox (G x G tiles) at the
    port's tile, rows from the band's first row y0 clamped to its nty tile
    rows (numpy): (tx0, tx1, ty0, ty1), (sx0, sx1, sy0, sy1)."""
    tx0, tx1 = arrays["xmin"] // tr.TILE_W, arrays["xmax"] // tr.TILE_W
    ty0, ty1 = ((arrays[r] - y0) // tr.TILE_H for r in ("ymin", "ymax"))
    if nty is not None:
        ty0, ty1 = np.clip(ty0, 0, nty - 1), np.clip(ty1, 0, nty - 1)
    tiles = (tx0, tx1, ty0, ty1)
    return tiles, tuple(v // g for v in tiles)


def check_segment_lists(binned, arrays, live, touch_lists, w, h, k, g, y0=0):
    """The segmented binner's exact contract, per tile of a w x h band at
    row y0 (a slot counts as live there if its bbox meets the band): the
    tile's segment is the live slots covering at most k tiles
    that touch it; its super-tile's segment is the live slots covering more
    than k tiles but at most k super-tiles that touch the super-tile; the
    residual list is the live slots covering more than k super-tiles; all
    ascending, lists contiguous in ids; bb_box each bb slot's bbox, in bb's
    order; and segment ∪ (super-tile segment ∩ touching) ∪ (residual ∩
    touching) is the JAX flat binner's touch set."""
    ids, starts, counts, bb, bb_count, bb_box = (a.numpy() for a in binned)
    s = live.size
    live = live & (arrays["ymin"] < y0 + h) & (arrays["ymax"] >= y0)
    ntx, nty = -(-w // tr.TILE_W), -(-h // tr.TILE_H)
    nsx, nsy = -(-ntx // g), -(-nty // g)
    ntiles = ntx * nty
    assert ids.shape == (k * s,) and bb.shape == (s,)
    assert starts.shape == counts.shape == (ntiles + nsx * nsy,)
    (tx0, tx1, ty0, ty1), (sx0, sx1, sy0, sy1) = super_tile_bbox(arrays, g, y0, nty)
    t_area = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    s_area = (sx1 - sx0 + 1) * (sy1 - sy0 + 1)
    mid = live & (t_area > k) & (s_area <= k)
    bb_list = bb[:int(bb_count[0])]
    np.testing.assert_array_equal(bb_list, np.nonzero(live & (s_area > k))[0])
    np.testing.assert_array_equal(starts[1:], np.cumsum(counts)[:-1])
    np.testing.assert_array_equal(bb_box, np.stack(
        [arrays[r][bb] for r in ("xmin", "xmax", "ymin", "ymax")], axis=-1))

    def segment(i):
        seg = ids[starts[i]:starts[i] + counts[i]]
        assert np.all(np.diff(seg) > 0)
        return seg

    for j in range(nsx * nsy):
        sy, sx = divmod(j, nsx)
        np.testing.assert_array_equal(segment(ntiles + j), np.nonzero(
            mid & (sx0 <= sx) & (sx <= sx1) & (sy0 <= sy) & (sy <= sy1))[0])
    for t, touching in enumerate(touch_lists):
        ty, tx = divmod(t, ntx)
        wide = np.concatenate([segment(ntiles + (ty // g) * nsx + tx // g),
                               bb_list])
        wide = wide[(tx0[wide] <= tx) & (tx <= tx1[wide])
                    & (ty0[wide] <= ty) & (ty <= ty1[wide])]
        np.testing.assert_array_equal(np.sort(np.concatenate([segment(t), wide])),
                                      touching)
    return bb_list, mid


@pytest.mark.parametrize("seed,w,h,k,g", [
    pytest.param(0, 200, 60, 4, 2, id="0"), pytest.param(1, 200, 60, 4, 2, id="1"),
    pytest.param(2, 200, 60, 4, 2, id="2"),
    pytest.param(3, 200, 60, 4, 3, id="3-g3"),
    pytest.param(4, 1500, 500, tr.SEG_K, tr.SEG_G, id="4-default-k-g")])
def test_bin_segments_partition_matches_jax_touch_sets(seed, w, h, k, g):
    """Per tile, the segment plus the super-tile segment's and the residual
    broadband list's slots whose bbox touches the tile is the JAX flat
    binner's touch set at the port's tile; every list is ascending and
    exactly what ``check_segment_lists`` states. Random bboxes on ragged
    grids (200 x 60 px is no multiple of the 32 x 8 tile, and neither grid
    of G x G super-tiles is whole), each list non-empty."""
    rng = np.random.default_rng(seed)
    s = 300
    xmin = rng.integers(0, w, s)
    ymin = rng.integers(0, h, s)
    arrays = dict(xmin=xmin, xmax=np.minimum(xmin + rng.integers(0, w * 4 // 5, s),
                                             w - 1),
                  ymin=ymin, ymax=np.minimum(ymin + rng.integers(0, h * 4 // 5, s),
                                             h - 1))
    arrays = {k_: v.astype(np.int32) for k_, v in arrays.items()}
    live = rng.random(s) < 0.8
    st = {k_: torch.from_numpy(v) for k_, v in arrays.items()}
    st["live"] = torch.from_numpy(live)
    binned = tr.bin_segments(st, width=w, height=h, k=k, g=g)
    assert all(a.dtype == torch.int32 for a in binned)
    bb_list, mid = check_segment_lists(binned, arrays, live,
                                       jax_touch_lists(arrays, live, w, h),
                                       w, h, k, g)
    assert 0 < bb_list.size < live.sum() and mid.any()


def test_bin_segments_keys_stay_in_int32_at_stress100k_on_4k():
    """stress100k's 201,606 slots on the 3840x2160 grid (32,400 port tiles,
    510 super-tiles): the JAX key ``tile * 2 * spow + mat * spow + slot``
    would reach 1.7e10 here, past int32; the port's key is the list index
    alone, at most ntiles + nsuper. Shapes and key range only, on synthetic
    bboxes: no frame is built."""
    s, w, h = 201_606, 3840, 2160
    ntx, nty = w // tr.TILE_W, h // tr.TILE_H
    ntiles, nsuper = tr.seg_lists(w, h)
    g = tr.SEG_G
    assert nsuper == -(-ntx // g) * -(-nty // g)
    spow = 1 << (s - 1).bit_length()
    assert ntx * nty * 2 * spow > 2 ** 31 - 1
    rng = np.random.default_rng(0)
    xmin = rng.integers(0, w, s)
    ymin = rng.integers(0, h, s)
    arrays = dict(xmin=xmin, xmax=np.minimum(xmin + rng.integers(0, 120, s), w - 1),
                  ymin=ymin, ymax=np.minimum(ymin + rng.integers(0, 40, s), h - 1))
    st = {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrays.items()}
    live = rng.random(s) < 0.9
    st["live"] = torch.from_numpy(live)
    keys, big = tr.segment_keys(st, width=w, height=h)
    assert keys.dtype == torch.int32 and keys.shape == (tr.SEG_K * s,)
    assert int(keys.min()) >= 0 and int(keys.max()) == ntiles + nsuper
    ids, starts, counts, bb, bb_count, bb_box = tr.bin_segments(st, width=w,
                                                                height=h)
    assert ids.shape == (tr.SEG_K * s,) and starts.shape == (ntiles + nsuper,)
    assert bb_box.shape == (s, 4)
    assert int(counts.sum()) == int((keys < ntiles + nsuper).sum())
    # The residual list is exactly the live slots covering more than SEG_K
    # super-tiles: none of these bboxes do; the wider ones are listed by
    # super-tile instead.
    _, (sx0, sx1, sy0, sy1) = super_tile_bbox(arrays, g)
    np.testing.assert_array_equal(
        big.numpy(), live & ((sx1 - sx0 + 1) * (sy1 - sy0 + 1) > tr.SEG_K))
    assert int(bb_count[0]) == int(big.sum()) == 0
    assert int(counts[ntiles:].sum()) > 0
    # Every entry decodes to a slot whose bbox covers its tile (or, in a
    # super-tile's segment, its super-tile), ascending within each list.
    n = int(counts.sum())
    lst = torch.repeat_interleave(torch.arange(ntiles + nsuper), counts.long())
    slot = ids[:n].long()
    in_tile = lst < ntiles
    tx = torch.where(in_tile, lst % ntx, (lst - ntiles) % -(-ntx // g))
    ty = torch.where(in_tile, lst // ntx, (lst - ntiles) // -(-ntx // g))
    cell_w = torch.where(in_tile, tr.TILE_W, tr.TILE_W * g)
    cell_h = torch.where(in_tile, tr.TILE_H, tr.TILE_H * g)
    assert bool(((st["xmin"][slot] // cell_w <= tx)
                 & (tx <= st["xmax"][slot] // cell_w)
                 & (st["ymin"][slot] // cell_h <= ty)
                 & (ty <= st["ymax"][slot] // cell_h)).all())
    same_list = lst[1:] == lst[:-1]
    assert bool((slot[1:][same_list] > slot[:-1][same_list]).all())


def test_segmented_plain_equals_flat_plain_on_default():
    """The order-independent tie rule over the tile, super-tile and residual
    lists gives the flat version's winners and frame, bit for bit, at 3
    poses of bench.py's flight (the counterpart of
    test_pallas_segmented_matches_resident_bitexact): at the default G the
    floor is listed by super-tile, at G = 2 it stays on the residual list."""
    dev = port_to_device(PORT_SCENES["default"](seed=0), "cpu")
    cam = port.Camera()
    w, h = 320, 240
    ntiles = tr.seg_lists(w, h)[0]
    for i in range(3):
        m = cam.update(port.Input(up=1.0, mouse=(2.0 * i, 0.0)),
                       force_update=(i == 0))
        setup = port_build_setup(dev, torch.as_tensor(m), width=w, height=h,
                                 config=port.DEFAULT_CONFIG)
        trf, tri = tr.pack_setup_tables(setup)
        rec = tr.pack_slot_records(setup)
        ids, counts = tr.bin_triangles(setup, width=w, height=h,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        pf, df = tr.raster_flat_nearest_plain(counts, ids, trf, tri,
                                              dev["textures"], width=w,
                                              height=h, background=BG)
        for g in (tr.SEG_G, 2):
            binned = tr.bin_segments(setup, width=w, height=h, g=g)
            if g == 2:
                assert int(binned[4][0]) > 0      # the floor goes broadband
            else:
                assert int(binned[2][ntiles:].sum()) > 0   # ... by super-tile
            ps, ds = tr.raster_segmented_nearest_plain(
                *binned, trf, tri, rec, dev["textures"], width=w, height=h,
                background=BG, g=g)
            assert torch.equal(ps, pf) and torch.equal(ds, df)
        assert bool((pf != BG).any())


@pytest.mark.parametrize("name", list(seg_variants.VARIANTS))
def test_seg_variant_rewrites_one_constant(name):
    """Each build variant of tools/seg_variants.py finds the default's line
    in csrc/raster.cu once and changes that line alone."""
    with open(os.path.join(kernels.CSRC, kernels.RASTER)) as f:
        src = f.read().splitlines()
    got = seg_variants.variant_source(name).splitlines()
    old, new = seg_variants.VARIANTS[name]
    assert len(got) == len(src)
    changed = [(a, b) for a, b in zip(src, got) if a != b]
    assert changed == [(old, new)]


@pytest.mark.parametrize("batch", [None, 3])
def test_slot_records_equal_table_rows(batch):
    """pack_slot_records: (..., S, 16) f32, contiguous; per slot the f32
    table's rows 0-11 (w00, dx, dy, rvz) and the i32 table's rows 0-3
    (xmin, xmax, ymin, ymax), bit for bit; a batch's frame b equals the
    frame's own records."""
    dev = port_to_device(PORT_SCENES["default"](seed=0), "cpu")
    ms = [port.Camera().update(port.Input(up=1.0, mouse=(3.0 * i, 1.0)),
                               force_update=True) for i in range(batch or 1)]
    m = torch.as_tensor(np.stack(ms) if batch else ms[0])
    setup = port_build_setup(dev, m, width=96, height=64,
                             config=port.DEFAULT_CONFIG)
    trf, tri = tr.pack_setup_tables(setup)
    rec = tr.pack_slot_records(setup)
    s = trf.shape[-1]
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    assert tuple(rec.shape) == (*trf.shape[:-2], s, tr.REC_WORDS)
    words = rec.view(torch.int32).transpose(-1, -2)        # (..., 16, S)
    assert torch.equal(words[..., :12, :], trf[..., :12, :].view(torch.int32))
    assert torch.equal(words[..., 12:, :], tri[..., :4, :])
    for b in range(batch or 0):
        one = tr.pack_slot_records({k: v[b] for k, v in setup.items()})
        assert torch.equal(rec[b].view(torch.int32), one.view(torch.int32))


W, H = 160, 120


@pytest.fixture(scope="module")
def stress128():
    """stress_scene(objects=128): 1,539 triangles, 3,078 slots, the JAX
    package's segmented single pass (and, at cap 1024, its multipass); the
    JAX setup table under the identity camera, the port's plain segmented
    frame from it, and golden's frame."""
    scene = stress_scene(seed=0, objects=128)
    dev = scene_to_device(scene)
    m = Camera().update(Input(), force_update=True)
    setup = build_setup(dev, jnp.asarray(m), width=W, height=H,
                        config=DEFAULT_CONFIG)
    assert setup["live"].shape[0] == 3078
    st = to_torch(setup)
    trf, tri = tr.pack_setup_tables(st)
    textures = torch.from_numpy(np.array(dev["textures"]).view(np.int32))
    binned = tr.bin_segments(st, width=W, height=H)
    best, win = tr.visibility_segmented_plain(*binned, trf, tri, width=W,
                                              height=H)
    pix = tr.shade_plain(best, win, trf, tri, textures, background=BG)
    gp, _ = golden_render(scene, m, W, H)
    return dict(setup=setup, textures=dev["textures"], golden=gp,
                port=(pix.numpy().view(np.uint32), best.numpy(), win.numpy()))


def assert_within_bounds(pix, depth, ref_pix, ref_depth, golden):
    assert pixel_mismatch_fraction(pix, ref_pix, tol=1) < 5e-4
    both = (ref_depth > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4)
    assert pixel_mismatch_fraction(pix, golden, tol=1) < 0.002
    assert pixel_mismatch_fraction(ref_pix, golden, tol=1) < 0.002
    assert (depth > 0).mean() > 0.2          # the frame is not empty


def test_segmented_plain_matches_pallas_single_pass(stress128):
    """One segmented pass of the Pallas kernel, winners tracked."""
    setup, s = stress128["setup"], 3078
    pj, dj, gj = (np.asarray(a[0]) for a in jr._rasterize_chunk(
        jax.tree.map(lambda a: a[None], setup), stress128["textures"],
        width=W, height=H, background=BG, tile_h=8, tile_w=128, y_offset=0,
        interpret=True, sampling="nearest",
        gids=jnp.arange(s, dtype=jnp.int32)))
    pix, depth, win = stress128["port"]
    assert (win == np.where(dj > 0, gj, -1)).mean() >= 0.9995
    assert_within_bounds(pix, depth, pj, dj, stress128["golden"])


def test_segmented_plain_matches_pallas_multipass(stress128):
    """JAX's live-compacted multipass at a 1024-slot cap (three passes
    merged by depth) against the port's one pass."""
    pj, dj = (np.asarray(a) for a in jr.rasterize_pallas(
        stress128["setup"], stress128["textures"], width=W, height=H,
        background=BG, tile_h=8, interpret=True, cap_override=1024))
    pix, depth, _ = stress128["port"]
    np.testing.assert_array_equal(depth > 0, dj > 0)
    assert_within_bounds(pix, depth, pj, dj, stress128["golden"])


def test_shading_sqrt_is_correctly_rounded_at_1_and_8_threads():
    """ROADMAP queue 3 item 5: the plain shading's normalisations
    (``_rsqrt3``) on a stress_scene(objects=128) frame at 320x240, the
    inputs that showed one channel step between CPU runs, computed at 1 and
    at 8 threads: equal to each other and to 1 / the correctly rounded
    float32 square root (numpy's), bit for bit, as the kernels' sqrtf gives
    it. torch.sqrt on the CPU is not correctly rounded on every build."""
    dev = port_to_device(PORT_SCENES["stress"](seed=0, objects=128), "cpu")
    m = port.Camera().update(port.Input(up=1.0), force_update=True)
    w, h = 320, 240
    setup = port_build_setup(dev, torch.as_tensor(m), width=w, height=h,
                             config=port.DEFAULT_CONFIG)
    trf, tri = tr.pack_setup_tables(setup)
    best, win = tr.visibility_segmented_plain(
        *tr.bin_segments(setup, width=w, height=h), trf, tri, width=w,
        height=h)
    yy, xx = torch.nonzero(win >= 0, as_tuple=True)
    s, inv = win[yy, xx].long(), 1.0 / best[yy, xx]

    def col(r):
        return trf[r][s]

    t = [(col(tr._W00 + k) + xx.float() * col(tr._DX + k)
          + yy.float() * col(tr._DY + k)) * inv for k in range(3)]
    vecs = [[col(base + k) * t[0] + col(base + 3 + k) * t[1]
             + col(base + 6 + k) * t[2] for k in range(3)]
            for base in (tr._CVP, tr._NP)]
    threads = torch.get_num_threads()
    got = {}
    try:
        for n in (1, 8):
            torch.set_num_threads(n)
            got[n] = [tr._rsqrt3(*v) for v in vecs]
    finally:
        torch.set_num_threads(threads)
    for v, one, eight in zip(vecs, got[1], got[8]):
        sq = (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]).numpy()
        want = torch.from_numpy(np.float32(1.0) / np.sqrt(sq))
        assert sq.size > 50_000
        assert torch.equal(one, eight) and torch.equal(one, want)
