"""Camera batches in the port (``Renderer.render_batch``, ``render_frames``,
the batched front-end, binners and kernels' plain versions) on CPU.

Frame b of a batch must equal frame b rendered alone, bit for bit: the setup
table key for key, the binners' outputs, and the pixels and depth. Against
the JAX package, ``render_batch`` holds to ``render_batch_pallas`` (interpret
mode, 8-row tiles) within pixel mismatch < 5e-4 at tol 1 and depth rtol 1e-4
where both are drawn, from the same numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops.raster_pallas import render_batch_pallas
from swift3drenderer_tpu.renderer import scene_to_device as jscene_to_device
import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.convert import device_arrays_from_numpy
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.renderer import (build_setup, render_frames,
                                                scene_to_device)

from conftest import pixel_mismatch_fraction

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

W, H = 160, 96
LAUNCHES = (tr.raster_flat_nearest, tr.raster_flat_bilinear,
            tr.raster_segmented_nearest, tr.raster_segmented_bilinear)


def random_poses(seed, n):
    """test_fuzz's random poses."""
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


def same_bits(a, b):
    """Equal bit for bit: floats compared as their int32 words, so a NaN of
    a dead slot equals the same NaN."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def into_scene(n):
    """Flying into the scene (the clipping scene's split triangles appear from
    the sixth pose on)."""
    cam = Camera()
    return np.stack([cam.update(Input(up=2.0), force_update=(i == 0)).copy()
                     for i in range(n)]).astype(np.float32)


@pytest.mark.parametrize("name", ["default", "clipping"])
def test_batched_setup_equals_per_frame_setup(name):
    """build_setup on a (B, 3, 4) batch: frame b's table is build_setup of
    its matrix alone, key for key, bit for bit (the slot order decides depth
    ties)."""
    dev = scene_to_device(PORT_SCENES[name](seed=0), "cpu")
    ms = torch.from_numpy(into_scene(13)[::6].copy())
    batch = build_setup(dev, ms, width=W, height=H,
                        config=port.DEFAULT_CONFIG)
    straddled = 0
    for b in range(ms.shape[0]):
        one = build_setup(dev, ms[b], width=W, height=H,
                          config=port.DEFAULT_CONFIG)
        assert set(batch) == set(one)
        for k, v in one.items():
            assert batch[k].shape == (ms.shape[0], *v.shape), k
            assert same_bits(batch[k][b], v), (k, b)
        straddled += int(one["live"][1::2].sum())     # appended split slots
    if name == "clipping":
        assert straddled > 0


@pytest.mark.parametrize("name", ["default", "regular_floor"])
def test_batched_binning_equals_per_frame_binning(name):
    """pack_setup_tables, bin_triangles and bin_segments on a batch: frame b
    of each output equals the single frame's (bin_segments sorts the whole
    batch at once, with each frame's keys offset past the previous frame's)."""
    dev = scene_to_device(PORT_SCENES[name](seed=0), "cpu")
    ms = torch.from_numpy(random_poses(5100, 3))
    batch = build_setup(dev, ms, width=W, height=H, config=port.DEFAULT_CONFIG)
    tables = tr.pack_setup_tables(batch)
    flat = tr.bin_triangles(batch, width=W, height=H, tile_h=tr.TILE_H,
                            tile_w=tr.TILE_W)
    segs = tr.bin_segments(batch, width=W, height=H)
    assert int(segs[2].sum()) > 0
    for b in range(3):
        one = {k: v[b] for k, v in batch.items()}
        for got, want in ((tables, tr.pack_setup_tables(one)),
                          (flat, tr.bin_triangles(one, width=W, height=H,
                                                  tile_h=tr.TILE_H,
                                                  tile_w=tr.TILE_W)),
                          (segs, tr.bin_segments(one, width=W, height=H))):
            for g, w in zip(got, want):
                assert same_bits(g[b], w)


@pytest.mark.parametrize("name,frames,sampling", [
    ("default", 3, "nearest"), ("default", 3, "bilinear"),
    ("regular_floor", 2, "nearest"), ("regular_floor", 2, "bilinear")])
def test_render_batch_equals_single_frames(name, frames, sampling):
    """Renderer.render_batch: one (B, H, W) pair of device tensors whose
    frame b equals render(ms[b]) bit for bit, pixels and depth; flat
    (default scene) and segmented (regular_floor, 3,700 slots). On CPU no
    kernel is launched."""
    scene = SCENES[name](seed=0)
    r = port.Renderer(scene, port.RenderConfig(sampling=sampling),
                      device="cpu")
    ms = random_poses(5000 if name == "default" else 5100, frames)
    before = [k.launches for k in LAUNCHES]
    pix, depth = r.render_batch(ms, W, H)
    assert [k.launches for k in LAUNCHES] == before
    assert pix.dtype == torch.int32 and tuple(pix.shape) == (frames, H, W)
    assert depth.dtype == torch.float32 and tuple(depth.shape) == (frames, H, W)
    for b in range(frames):
        px, d = r.render(ms[b], W, H)
        np.testing.assert_array_equal(pix[b].numpy().view(np.uint32), px)
        np.testing.assert_array_equal(depth[b].numpy(), d)
    assert (depth > 0).float().mean() > 0.1
    with pytest.raises(ValueError):
        r.render_batch(ms[0], W, H)


def test_render_batch_matches_jax_render_batch_pallas():
    """test_fuzz's batch (default scene, seed 3, three random poses, 160x96)
    through the port's render_batch and the JAX package's
    render_batch_pallas, from the same numpy arrays."""
    scene = SCENES["default"](seed=3)
    jdev = jscene_to_device(scene)
    tdev = device_arrays_from_numpy({k: np.asarray(v) for k, v in jdev.items()},
                                    "cpu")
    ms = random_poses(5000, 3)
    pix, depth = render_frames(
        tdev, torch.from_numpy(ms), width=W, height=H)
    ref_pix, ref_depth = (np.asarray(a) for a in render_batch_pallas(
        jdev, jnp.asarray(ms), width=W, height=H, interpret=True, tile_h=8))
    for b in range(3):
        px, d = pix[b].numpy().view(np.uint32), depth[b].numpy()
        assert pixel_mismatch_fraction(px, ref_pix[b], tol=1) < 5e-4, b
        np.testing.assert_array_equal(d > 0, ref_depth[b] > 0)
        both = (d > 0) & (ref_depth[b] > 0)
        np.testing.assert_allclose(d[both], ref_depth[b][both], rtol=1e-4)
    assert (depth > 0).float().mean() > 0.2


@pytest.mark.parametrize("limit,name", [
    ("LAUNCH_MAX_FRAMES", "default"), ("LAUNCH_MAX_FRAMES", "regular_floor"),
    ("TABLE_MAX_WORDS", "default"), ("TABLE_MAX_WORDS", "regular_floor"),
    ("SORT_MAX_KEYS", "regular_floor")])
def test_batch_past_a_launch_limit_splits(monkeypatch, limit, name):
    """A batch past one launch's limit renders in several launches: with the
    limit monkeypatched down to two frames' worth, five frames take three
    launches (2 + 2 + 1) of the route's kernel, and the batch equals the
    one-launch batch bit for bit, pixels, depth and tracked gids. A single
    launch past the limit is still refused (``_frame_dims`` for the grid and
    the table, ``bin_segments`` for the sort keys). Flat (default scene) and
    segmented (regular_floor) routes."""
    dev = scene_to_device(PORT_SCENES[name](seed=0), "cpu")
    ms = torch.from_numpy(random_poses(5100, 5))
    w, h = 64, 48
    setup = build_setup(dev, ms, width=w, height=h, config=port.DEFAULT_CONFIG)
    s = setup["live"].shape[-1]
    route = tr._FLAT if s <= tr.FLAT_MAX_SLOTS else tr._SEGMENTED
    gids = 2 * 50 + torch.arange(s, dtype=torch.int32)
    kw = dict(width=w, height=h, background=port.DEFAULT_CONFIG.background_packed)
    whole = tr.rasterize(setup, dev["textures"], **kw)
    whole_ids = tr.rasterize(setup, dev["textures"], gids=gids, **kw)
    two = {"LAUNCH_MAX_FRAMES": 2, "TABLE_MAX_WORDS": 2 * tr._F32_ROWS * s,
           "SORT_MAX_KEYS": 2 * (sum(tr.seg_lists(w, h)) + 1)}[limit]
    monkeypatch.setattr(tr, limit, two)
    launches = []
    kernel = route["nearest"]
    monkeypatch.setitem(route, "nearest",
                        lambda *a, **k: launches.append(a[0].shape[0]) or kernel(*a, **k))
    split = tr.rasterize(setup, dev["textures"], **kw)
    assert launches == [2, 2, 1]
    assert all(same_bits(a, b) for a, b in zip(split, whole))
    split_ids = tr.rasterize(setup, dev["textures"], gids=gids, **kw)
    assert all(same_bits(a, b) for a, b in zip(split_ids, whole_ids))
    assert bool((whole[1] > 0).any())
    three = {k: v[:3] for k, v in setup.items()}
    if limit == "SORT_MAX_KEYS":
        with pytest.raises(ValueError, match="sort keys"):
            tr.bin_segments(three, width=w, height=h)
    else:
        with pytest.raises(ValueError, match="launch"):
            tr._frame_dims(tr.pack_setup_tables(three)[0])
