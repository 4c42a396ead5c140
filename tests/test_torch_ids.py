"""Winner-id tracking and framebuffer bands in the port, held against the JAX
package on CPU: ``pack_setup_tables(gids)``, the band binners
(``y_offset``), the plain versions of the kernels' tracking forms, the
per-range pipeline ``renderer.render_range`` and a scene of more than 96
textures in one pass.

The JAX side runs as tests/test_pallas.py runs it: the Pallas kernel in
interpret mode, here with 8-row tiles (three compiles in this file). Bounds:
gid planes equal wherever both sides have a winner (so the winners are the
same) and -1 (kernel planes) or 2**30 (``rasterize`` planes) elsewhere;
pixel mismatch < 5e-4 at tol 1; depth rtol 1e-4 where both are drawn, drawn
sets equal; golden within 0.2 % (0.3 % for the textured icosahedron).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES, stress_scene
from swift3drenderer_tpu.models.textures import default_texture_words
from swift3drenderer_tpu.ops import raster_pallas as jr
from swift3drenderer_tpu.renderer import build_corners, scene_to_device
import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.convert import device_arrays_from_numpy
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.parallel import merge_depth_gid
from swift3drenderer_tpu_torch.renderer import build_setup as port_build_setup
from swift3drenderer_tpu_torch.renderer import render_frame, render_range
from swift3drenderer_tpu_torch.renderer import scene_to_device as port_to_device

from conftest import pixel_mismatch_fraction
from test_torch_segmented import check_segment_lists

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

BG = DEFAULT_CONFIG.background_packed


def to_torch(setup):
    return {k: torch.from_numpy(np.array(v)) for k, v in setup.items()}


def to_jax(setup):
    return {k: jnp.asarray(v.numpy()) for k, v in setup.items()}


def port_arrays(jdev):
    return device_arrays_from_numpy({k: np.asarray(v) for k, v in jdev.items()},
                                    "cpu")


def assert_tracked(pix, depth, gid, ref_pix, ref_depth, ref_gid, none=-1,
                   ref_none=-1):
    """Port (pix, depth, gid) numpy frames against the JAX ones: equal drawn
    sets, equal gids where drawn and ``none`` / ``ref_none`` elsewhere,
    pixels and depth within the bounds."""
    drawn = depth > 0
    np.testing.assert_array_equal(drawn, ref_depth > 0)
    np.testing.assert_array_equal(gid[drawn], ref_gid[drawn])
    assert (gid[~drawn] == none).all() and (ref_gid[~drawn] == ref_none).all()
    assert pixel_mismatch_fraction(pix, ref_pix, tol=1) < 5e-4
    np.testing.assert_allclose(depth[drawn], ref_depth[drawn], rtol=1e-4)
    assert drawn.mean() > 0.1


def random_poses(seed, n):
    """test_fuzz's random poses (as tests/test_torch_batch.py makes them)."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        cam = Camera()
        cam.update(Input(), force_update=True)
        for _ in range(rng.integers(1, 6)):
            cam.update(Input(
                up=float(rng.uniform(0, 2)), down=float(rng.uniform(0, 1)),
                left=float(rng.uniform(0, 1)), right=float(rng.uniform(0, 1)),
                mouse=(float(rng.uniform(-120, 120)),
                       float(rng.uniform(-80, 80)))))
        poses.append(cam.matrix.copy())
    return np.stack(poses).astype(np.float32)


def u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def default2():
    """The default scene's setup tables for two of test_torch_batch's poses
    (test_fuzz's random poses) at 128 x 96, made by the port's front-end,
    which equals the JAX one key for key (tests/test_torch_geometry.py and
    test_torch_batch.py), as JAX arrays. bench.py's first flight
    pose is not among them: it puts floor texels on boundaries where XLA's
    CPU multiply-add contraction flips pixels of the Pallas frame (ROADMAP
    queue 3; test_texel_boundary_pose_within_golden_bound holds that
    pose)."""
    jdev = scene_to_device(SCENES["default"](seed=0))
    setup = port_build_setup(port_arrays(jdev),
                             torch.from_numpy(random_poses(5002, 2)),
                             width=128, height=96, config=port.DEFAULT_CONFIG)
    return jdev, to_jax(setup)


def test_pack_setup_tables_gids_match_jax(default2):
    """Row _GID holds the given gids, shared by a batch or one row per
    frame; every other row as before; equal to the JAX tables."""
    setup = jax.tree.map(lambda a: a[0], default2[1])
    s = setup["live"].shape[0]
    gids = 2 * 37 + np.arange(s, dtype=np.int32)
    jf, ji = (np.asarray(a) for a in jr.pack_setup_tables(setup, jnp.asarray(gids)))
    st = to_torch(setup)
    tf, ti = tr.pack_setup_tables(st, torch.from_numpy(gids))
    np.testing.assert_array_equal(tf.numpy().view(np.int32), jf.view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), ji)
    df, di = tr.pack_setup_tables(st)
    assert torch.equal(df.view(torch.int32), tf.view(torch.int32))
    assert torch.equal(di[:tr._GID], ti[:tr._GID])
    assert torch.equal(di[tr._GID], torch.arange(s, dtype=torch.int32))
    batch = {k: torch.stack([v, v]) for k, v in st.items()}
    per_frame = torch.from_numpy(np.stack([gids, gids + 1000]))
    _, bi = tr.pack_setup_tables(batch, per_frame)
    assert torch.equal(bi[0], ti) and torch.equal(bi[1][tr._GID], ti[tr._GID] + 1000)


@pytest.mark.parametrize("seed", [0, 1])
def test_band_binning_matches_jax_touch_sets(seed):
    """On a ragged band (rows 37-86 of a 120-row frame; 50 rows, no multiple
    of 8) of random full-frame bboxes: bin_triangles equals the JAX binner at
    the same y_offset (ids and counts), and each tile's segment plus the
    broadband slots that touch it is the JAX touch set. Slots wholly above
    or below the band bin nowhere. The segmented binner's lists over the
    band's tiles and super-tiles meet ``check_segment_lists``' exact
    contract at the default K and G and at K = 4, G = 2 (a ragged grid of
    super-tiles with a residual list)."""
    rng = np.random.default_rng(seed)
    s, w, full_h, y0, h = 300, 200, 120, 37, 50
    xmin = rng.integers(0, w, s)
    ymin = rng.integers(0, full_h, s)
    arrays = dict(xmin=xmin, xmax=np.minimum(xmin + rng.integers(0, 160, s), w - 1),
                  ymin=ymin, ymax=np.minimum(ymin + rng.integers(0, 48, s), full_h - 1))
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    live = rng.random(s) < 0.8
    sj = {k: jnp.asarray(v) for k, v in arrays.items()}
    sj["live"] = jnp.asarray(live)
    jids, jcounts = (np.asarray(a) for a in jr.bin_triangles(
        sj, width=w, height=h, tile_h=tr.TILE_H, tile_w=tr.TILE_W, y_offset=y0))
    st = {k: torch.from_numpy(v) for k, v in arrays.items()}
    st["live"] = torch.from_numpy(live)
    ids, counts = tr.bin_triangles(st, width=w, height=h, tile_h=tr.TILE_H,
                                   tile_w=tr.TILE_W, y_offset=y0)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    outside = live & ((arrays["ymax"] < y0) | (arrays["ymin"] >= y0 + h))
    assert outside.any()
    binned = np.unique(np.concatenate(
        [jids[t, :jcounts[t, 0]] for t in range(jids.shape[0])]))
    assert not np.isin(np.nonzero(outside)[0], binned).any()

    jlists = [jids[t, :jcounts[t, 0]] for t in range(jids.shape[0])]
    for k, g in ((tr.SEG_K, tr.SEG_G), (4, 2)):
        binned = tr.bin_segments(st, width=w, height=h, k=k, g=g, y_offset=y0)
        bb_list, _ = check_segment_lists(binned, arrays, live, jlists, w, h,
                                         k, g, y0=y0)
        assert not np.isin(bb_list, np.nonzero(outside)[0]).any()
        ntiles = tr.seg_lists(w, h, g)[0]
        assert int(binned[2][ntiles:].sum()) > 0
    assert bb_list.size > 0


def test_flat_tracking_band_matches_pallas_chunk(default2):
    """The flat tracking form on a ragged band of a camera batch: the plain
    version (and ``rasterize(gids, y_offset)``) against
    ``_rasterize_chunk(gids=..., y_offset=...)`` of the Pallas kernel's flat
    form, whose band path ``rasterize_pallas_batch`` runs; the segmented
    plain version gives the flat one's frame bit for bit; stitched bands
    give the whole frame."""
    w, full_h, y0, h = 128, 96, 40, 36
    jdev, setup = default2
    s = setup["live"].shape[1]
    assert s + 3 <= 128                       # the JAX kernel's flat form
    gids = 2 * 9 + np.arange(s, dtype=np.int32)
    jp, jd, jg = (np.asarray(a) for a in jax.jit(partial(
        jr._rasterize_chunk, width=w, height=h, background=BG, tile_h=8,
        tile_w=128, y_offset=y0, interpret=True, sampling="nearest"))(
            setup, jdev["textures"], gids=jnp.asarray(gids)))
    st = to_torch(setup)
    tex = port_arrays(jdev)["textures"]
    trf, tri = tr.pack_setup_tables(st, torch.from_numpy(gids))
    ids, counts = tr.bin_triangles(st, width=w, height=h, tile_h=tr.TILE_H,
                                   tile_w=tr.TILE_W, y_offset=y0)
    kw = dict(width=w, height=h, background=BG, y_offset=y0, track_ids=True)
    pf, df, gf = tr.raster_flat_nearest(counts, ids, trf, tri, tex, **kw)
    for b in range(2):
        assert_tracked(u32(pf[b]), df[b].numpy(), gf[b].numpy(), jp[b], jd[b],
                       jg[b])
    binned = tr.bin_segments(st, width=w, height=h, y_offset=y0)
    ps, ds, gs = tr.raster_segmented_nearest(*binned, trf, tri,
                                             tr.pack_slot_records(st), tex, **kw)
    assert torch.equal(ps, pf) and torch.equal(ds, df) and torch.equal(gs, gf)
    pr, dr, gr = tr.rasterize(st, tex, width=w, height=h, background=BG,
                              gids=torch.from_numpy(gids), y_offset=y0)
    assert torch.equal(pr, pf) and torch.equal(dr, df)
    assert torch.equal(gr, torch.where(df > 0, gf, tr.NO_GID))
    full = tr.rasterize(st, tex, width=w, height=full_h, background=BG)
    bands = [tr.rasterize(st, tex, width=w, height=24, background=BG,
                          y_offset=y) for y in range(0, full_h, 24)]
    for got, want in zip((torch.cat(p, dim=1) for p in zip(*bands)), full):
        assert torch.equal(got, want)
    assert torch.equal(full[0][:, y0:y0 + h], pf)


def test_tracking_rejects_gids_out_of_slot_order():
    """The precondition, checked by the plain versions: gids ascend with
    slot order among a frame's live slots."""
    dev = port_to_device(PORT_SCENES["default"](seed=0), "cpu")
    m = torch.as_tensor(port.Camera().update(port.Input(), force_update=True))
    setup = port_build_setup(dev, m, width=64, height=48,
                             config=port.DEFAULT_CONFIG)
    gids = torch.arange(setup["live"].shape[0], dtype=torch.int32).flip(0)
    with pytest.raises(ValueError, match="ascend"):
        tr.rasterize(setup, dev["textures"], width=64, height=48,
                     background=BG, gids=gids)


W, H = 128, 32


@pytest.fixture(scope="module")
def stress220():
    """stress_scene(seed=1, objects=220) (2,643 triangles, 5,286 slots) one
    step into the flight, as test_pallas_corners_ids_gid_base_offsets_
    globally flies it; the JAX per-range pipeline at gid_base 700 with a
    slot cap past 2T, so it is one segmented ``_rasterize_chunk(gids=...)``
    pass; the port's setup table (equal to the JAX one key for key,
    tests/test_torch_geometry.py) and golden's frame."""
    scene = stress_scene(seed=1, objects=220)
    jdev = scene_to_device(scene)
    cam = Camera()
    cam.update(Input(), force_update=True)
    m = cam.update(Input(up=1.0)).copy()
    corners = jax.tree.map(lambda a: a[None], build_corners(
        jdev, jnp.asarray(m), width=W, height=H, config=DEFAULT_CONFIG))
    t = scene.num_triangles
    kw = dict(near=DEFAULT_CONFIG.near, factor=DEFAULT_CONFIG.factor(H),
              half_w=W / 2.0, half_h=H / 2.0, min_area=DEFAULT_CONFIG.min_area,
              cap=2 * t, width=W, height=H, background=BG, tile_h=8,
              tile_w=128, y_offset=0, interpret=True, sampling="nearest")
    ref = tuple(np.asarray(a[0]) for a in jax.jit(partial(
        jr._rasterize_corners_ids, gid_base=700, **kw))(
            corners, jdev["textures"]))
    dev = port_arrays(jdev)
    setup = port_build_setup(dev, torch.as_tensor(m), width=W, height=H,
                             config=port.DEFAULT_CONFIG)
    gp, _ = golden_render(scene, m, W, H)
    return dict(dev=dev, m=m, ref=ref, setup=setup, golden=gp, t=t)


def test_tracking_plain_versions_match_pallas(stress220):
    """The flat and segmented plain tracking versions on the setup table
    with gids 2 * 700 + slot, against the Pallas segmented tracking pass."""
    st, t = stress220["setup"], stress220["t"]
    gids = torch.arange(2 * t, dtype=torch.int32) + 1400
    trf, tri = tr.pack_setup_tables(st, gids)
    tex = stress220["dev"]["textures"]
    kw = dict(width=W, height=H, background=BG, track_ids=True)
    binned = tr.bin_segments(st, width=W, height=H)
    ps, ds, gs = tr.raster_segmented_nearest(*binned, trf, tri,
                                             tr.pack_slot_records(st), tex, **kw)
    jp, jd, jg = stress220["ref"]
    assert_tracked(u32(ps), ds.numpy(), gs.numpy(), jp, jd, jg,
                   ref_none=tr.NO_GID)
    ids, counts = tr.bin_triangles(st, width=W, height=H, tile_h=tr.TILE_H,
                                   tile_w=tr.TILE_W)
    pf, df, gf = tr.raster_flat_nearest(counts, ids, trf, tri, tex, **kw)
    assert torch.equal(pf, ps) and torch.equal(df, ds) and torch.equal(gf, gs)
    assert pixel_mismatch_fraction(u32(ps), stress220["golden"], tol=1) < 0.002


def test_render_range_matches_pallas_corners_ids(stress220):
    """The per-range pipeline on the whole scene against
    ``_rasterize_corners_ids``: the JAX gid_base shifts every winner's gid by
    2 * base (here 1400) and leaves the frame, the port's range gives the
    same frame with gids 2 * slot; two ranges merge to the whole range and
    to ``render_frame`` bit for bit; padded and empty ranges stay dead."""
    dev = stress220["dev"]
    m, t = torch.as_tensor(stress220["m"]), stress220["t"]
    pix, depth, gid = render_range(dev, m, lo=0, count=t, width=W, height=H)
    jp, jd, jg = stress220["ref"]
    drawn = (depth > 0).numpy()
    assert_tracked(u32(pix), depth.numpy(),
                   np.where(drawn, gid.numpy() + 1400, -1), jp, jd,
                   np.where(jd > 0, jg, -1))
    assert bool((gid[depth == 0] == tr.NO_GID).all())

    lo = 700
    head = render_range(dev, m, lo=0, count=lo, width=W, height=H)
    tail = render_range(dev, m, lo=lo, count=t - lo, width=W, height=H)
    assert bool((tail[2][tail[1] > 0] >= 2 * lo).all())
    for got, want in zip(merge_depth_gid(*head, *tail), (pix, depth, gid)):
        assert torch.equal(got, want)
    one_p, one_d = render_frame(dev, m, width=W, height=H)
    assert torch.equal(one_p, pix) and torch.equal(one_d, depth)

    padded = render_range(dev, m, lo=t - 40, count=100, width=W, height=H)
    for got, want in zip(padded, render_range(dev, m, lo=t - 40, count=40,
                                              width=W, height=H)):
        assert torch.equal(got, want)
    empty = render_range(dev, m, lo=t + 3, count=10, width=W, height=H)
    assert bool((empty[0] == BG).all() and (empty[1] == 0).all()
                and (empty[2] == tr.NO_GID).all())


def many_textures(scene, n):
    """``scene`` with an atlas of n textures (test_pallas's two default
    textures, repeated) and its textured triangles spread over all of them."""
    big = dataclasses.replace(
        scene, textures=np.concatenate([default_texture_words(2)] * (n // 2)))
    tex = big.attr_tex.copy()
    for t, corners in enumerate(big.attribute_indices.reshape(-1, 3)):
        for a in corners:
            if tex[a] >= 0:
                tex[a] = (53 * t) % n
    big.attr_tex = tex
    big.validate()
    return big


def test_many_textures_in_one_pass_match_pallas_pages(monkeypatch):
    """98 textures, past the JAX kernel's 96-texture VMEM atlas: the JAX
    package renders them in texture pages merged by (depth, global id)
    (``_rasterize_texture_paged``; the page size patched to 49 so both pages
    share one compile, as test_pallas_many_textures_pages patches it), the
    port in one pass over the whole atlas. Textured triangles fall in both
    pages. The pose is test_torch_bilinear's icosahedron pose, one flight
    step in (from the identity camera XLA's CPU multiply-add contraction
    flips texels of the Pallas frame, ROADMAP queue 3)."""
    scene = many_textures(SCENES["icosahedron"](seed=0), 98)
    w, h = 128, 32
    cam = Camera()
    cam.update(Input(), force_update=True)
    m = cam.update(Input(up=1.0, mouse=(8.0, 4.0))).copy()
    used = np.unique(scene.attr_tex[scene.attr_tex >= 0])
    assert (used < 49).any() and (used >= 49).any()
    jdev = scene_to_device(scene)
    setup = to_jax(port_build_setup(port_arrays(jdev), torch.as_tensor(m),
                                    width=w, height=h,
                                    config=port.DEFAULT_CONFIG))
    monkeypatch.setattr(jr, "MAX_ATLAS_TEXTURES", 49)
    jp, jd = (np.asarray(a[0]) for a in jax.jit(partial(
        jr._rasterize_texture_paged, cap=4096, width=w, height=h,
        background=BG, tile_h=8, tile_w=128, y_offset=0, interpret=True,
        sampling="nearest"))(jax.tree.map(lambda a: a[None], setup),
                             jdev["textures"]))
    passes = []
    plain = tr.raster_flat_plain
    monkeypatch.setattr(tr, "raster_flat_plain",
                        lambda *a, **k: passes.append(1) or plain(*a, **k))
    pix, depth = port.Renderer(scene, device="cpu").render(m, w, h)
    assert len(passes) == 1
    np.testing.assert_array_equal(depth > 0, jd > 0)
    assert pixel_mismatch_fraction(pix, jp, tol=1) < 5e-4
    both = depth > 0
    np.testing.assert_allclose(depth[both], jd[both], rtol=1e-4)
    gp, _ = golden_render(scene, m, w, h)
    assert pixel_mismatch_fraction(pix, gp, tol=1) < 0.003
    assert both.mean() > 0.1


def test_merge_depth_gid_keeps_the_smaller_gid_at_a_tie():
    """Two renders of the same slots with gids 1000 apart tie at every drawn
    pixel: the merge keeps the smaller gid (the earlier triangle,
    render.swift:324) in either order, takes the greater 1/z where they
    differ, and keeps (background, 0, NO_GID) where nothing covers."""
    dev = port_to_device(PORT_SCENES["default"](seed=0), "cpu")
    m = torch.as_tensor(port.Camera().update(port.Input(), force_update=True))
    setup = port_build_setup(dev, m, width=64, height=48,
                             config=port.DEFAULT_CONFIG)
    s = setup["live"].shape[0]
    kw = dict(width=64, height=48, background=BG)
    a = tr.rasterize(setup, dev["textures"], **kw,
                     gids=torch.arange(s, dtype=torch.int32))
    b = tr.rasterize(setup, dev["textures"], **kw,
                     gids=torch.arange(s, dtype=torch.int32) + 1000)
    drawn = a[1] > 0
    assert bool(drawn.any()) and bool((~drawn).any())
    for got in (merge_depth_gid(*a, *b), merge_depth_gid(*b, *a)):
        for g, want in zip(got, a):
            assert torch.equal(g, want)
    nearer = (a[0], a[1] * 2, b[2])      # same pixels, greater 1/z, gids + 1000
    for got in (merge_depth_gid(*a, *nearer), merge_depth_gid(*nearer, *a)):
        assert torch.equal(got[1][drawn], nearer[1][drawn])
        assert torch.equal(got[2][drawn], b[2][drawn])
        assert bool((got[2][~drawn] == tr.NO_GID).all())
