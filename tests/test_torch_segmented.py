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
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.renderer import build_setup as port_build_setup
from swift3drenderer_tpu_torch.renderer import scene_to_device as port_to_device

from conftest import pixel_mismatch_fraction

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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_segments_partition_matches_jax_touch_sets(seed):
    """Per tile, the segment plus the broadband slots whose bbox touches the
    tile is the JAX flat binner's touch set at the port's tile; segments and
    the broadband list are ascending; broadband is exactly the live slots
    covering more than SEG_K tiles. Random bboxes on a ragged grid
    (200 x 60 px is no multiple of the 32 x 8 tile)."""
    rng = np.random.default_rng(seed)
    s, w, h = 300, 200, 60
    xmin = rng.integers(0, w, s)
    ymin = rng.integers(0, h, s)
    arrays = dict(xmin=xmin, xmax=np.minimum(xmin + rng.integers(0, 160, s), w - 1),
                  ymin=ymin, ymax=np.minimum(ymin + rng.integers(0, 48, s), h - 1))
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    live = rng.random(s) < 0.8
    st = {k: torch.from_numpy(v) for k, v in arrays.items()}
    st["live"] = torch.from_numpy(live)
    ids, starts, counts, bb, bb_count = tr.bin_segments(st, width=w, height=h)
    assert ids.dtype == starts.dtype == counts.dtype == bb.dtype == torch.int32
    assert ids.shape == (tr.SEG_K * s,) and bb.shape == (s,)
    ids, starts, counts = ids.numpy(), starts.numpy(), counts.numpy()
    bb_list = bb.numpy()[:int(bb_count[0])]

    ntx = -(-w // tr.TILE_W)
    tx0, tx1 = arrays["xmin"] // tr.TILE_W, arrays["xmax"] // tr.TILE_W
    ty0, ty1 = arrays["ymin"] // tr.TILE_H, arrays["ymax"] // tr.TILE_H
    area = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    np.testing.assert_array_equal(bb_list, np.nonzero(live & (area > tr.SEG_K))[0])
    assert 0 < bb_list.size < live.sum()
    np.testing.assert_array_equal(starts[1:], np.cumsum(counts)[:-1])
    for t, touching in enumerate(jax_touch_lists(arrays, live, w, h)):
        ty, tx = divmod(t, ntx)
        seg = ids[starts[t]:starts[t] + counts[t]]
        assert np.all(np.diff(seg) > 0)
        wide = bb_list[(tx0[bb_list] <= tx) & (tx <= tx1[bb_list])
                       & (ty0[bb_list] <= ty) & (ty <= ty1[bb_list])]
        np.testing.assert_array_equal(np.sort(np.concatenate([seg, wide])),
                                      touching)


def test_bin_segments_keys_stay_in_int32_at_stress100k_on_4k():
    """stress100k's 201,606 slots on the 3840x2160 grid (32,400 port tiles):
    the JAX key ``tile * 2 * spow + mat * spow + slot`` would reach 1.7e10
    here, past int32; the port's key is the tile index alone, at most
    ntiles. Shapes and key range only, on synthetic bboxes: no frame is
    built."""
    s, w, h = 201_606, 3840, 2160
    ntx, nty = w // tr.TILE_W, h // tr.TILE_H
    spow = 1 << (s - 1).bit_length()
    assert ntx * nty * 2 * spow > 2 ** 31 - 1
    rng = np.random.default_rng(0)
    xmin = rng.integers(0, w, s)
    ymin = rng.integers(0, h, s)
    arrays = dict(xmin=xmin, xmax=np.minimum(xmin + rng.integers(0, 120, s), w - 1),
                  ymin=ymin, ymax=np.minimum(ymin + rng.integers(0, 40, s), h - 1))
    st = {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrays.items()}
    st["live"] = torch.from_numpy(rng.random(s) < 0.9)
    keys, big = tr.segment_keys(st, width=w, height=h)
    assert keys.dtype == torch.int32 and keys.shape == (tr.SEG_K * s,)
    assert int(keys.min()) >= 0 and int(keys.max()) == ntx * nty
    ids, starts, counts, bb, bb_count = tr.bin_segments(st, width=w, height=h)
    assert ids.shape == (tr.SEG_K * s,) and starts.shape == (ntx * nty,)
    assert int(counts.sum()) == int((keys < ntx * nty).sum())
    assert int(bb_count[0]) == int(big.sum()) > 0
    # Every entry decodes to a slot whose bbox covers its tile, ascending
    # within each tile.
    n = int(counts.sum())
    tile = torch.repeat_interleave(torch.arange(ntx * nty), counts.long())
    slot = ids[:n].long()
    tx, ty = tile % ntx, tile // ntx
    assert bool(((st["xmin"][slot] // tr.TILE_W <= tx)
                 & (tx <= st["xmax"][slot] // tr.TILE_W)
                 & (st["ymin"][slot] // tr.TILE_H <= ty)
                 & (ty <= st["ymax"][slot] // tr.TILE_H)).all())
    same_tile = tile[1:] == tile[:-1]
    assert bool((slot[1:][same_tile] > slot[:-1][same_tile]).all())


def test_segmented_plain_equals_flat_plain_on_default():
    """The order-independent tie rule over segments and broadband gives the
    flat version's winners and frame, bit for bit, at 3 poses of bench.py's
    flight (the counterpart of test_pallas_segmented_matches_resident_bitexact)."""
    dev = port_to_device(PORT_SCENES["default"](seed=0), "cpu")
    cam = port.Camera()
    w, h = 320, 240
    for i in range(3):
        m = cam.update(port.Input(up=1.0, mouse=(2.0 * i, 0.0)),
                       force_update=(i == 0))
        setup = port_build_setup(dev, torch.as_tensor(m), width=w, height=h,
                                 config=port.DEFAULT_CONFIG)
        trf, tri = tr.pack_setup_tables(setup)
        ids, counts = tr.bin_triangles(setup, width=w, height=h,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        pf, df = tr.raster_flat_nearest_plain(counts, ids, trf, tri,
                                              dev["textures"], width=w,
                                              height=h, background=BG)
        binned = tr.bin_segments(setup, width=w, height=h)
        assert int(binned[4][0]) > 0          # the floor goes broadband
        ps, ds = tr.raster_segmented_nearest_plain(
            *binned, trf, tri, dev["textures"], width=w, height=h,
            background=BG)
        assert torch.equal(ps, pf) and torch.equal(ds, df)
        assert bool((pf != BG).any())


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
