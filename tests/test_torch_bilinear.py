"""Bilinear sampling in the port (``RenderConfig(sampling="bilinear")``, the
plain versions of ``raster_flat_bilinear`` and ``raster_segmented_bilinear``)
held against the JAX package on CPU.

Both packages render from the same numpy arrays
(``convert.device_arrays_from_numpy``). The JAX Pallas kernel runs in
interpret mode with 8-row tiles (winners do not depend on the tiling; short
tiles keep each compile to seconds). Bounds: pixel mismatch < 5e-4 at tol 1
against Pallas (the bound test_pallas_matches_xla keeps between the JAX
package's own two paths), depth rtol 1e-4 where both are drawn, and < 0.003
against golden (test_backends_match_golden_bilinear's bound).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES, stress_scene
from swift3drenderer_tpu.ops import texture as jtexture
from swift3drenderer_tpu.ops.raster_pallas import render_frame_pallas
from swift3drenderer_tpu.renderer import scene_to_device as jscene_to_device
import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.convert import device_arrays_from_numpy
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.ops import raster as tr
from swift3drenderer_tpu_torch.ops import texture as ttexture
from swift3drenderer_tpu_torch.renderer import (build_setup, render_frame,
                                                scene_to_device)
from swift3drenderer_tpu_torch.utils.ppm import pack_rgb_words
from swift3drenderer_tpu_torch.utils.ripmap import level_offset

from conftest import pixel_mismatch_fraction

JAX_BILINEAR = dataclasses.replace(JAX_DEFAULT, sampling="bilinear")
BILINEAR = port.RenderConfig(sampling="bilinear")
BG = port.DEFAULT_CONFIG.background_packed
W, H = 160, 120


def both_devices(scene):
    """The JAX package's device arrays and the port's, from the same numpy."""
    jdev = jscene_to_device(scene)
    return jdev, device_arrays_from_numpy(
        {k: np.asarray(v) for k, v in jdev.items()}, "cpu")


def port_frame(tdev, m, config=BILINEAR):
    pix, depth = render_frame(tdev, torch.as_tensor(np.asarray(m, np.float32)),
                              width=W, height=H, config=config)
    return pix.numpy().view(np.uint32), depth.numpy()


def assert_matches_pallas_and_golden(px, depth, ref_px, ref_depth, golden,
                                     what):
    assert pixel_mismatch_fraction(px, ref_px, tol=1) < 5e-4, what
    np.testing.assert_array_equal(depth > 0, ref_depth > 0, err_msg=what)
    both = (ref_depth > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4,
                               err_msg=what)
    assert pixel_mismatch_fraction(px, golden, tol=1) < 0.003, what


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_ripmap_bilinear_matches_jax(seed):
    """The bilinear sampler against the JAX package's on seeded uv (negative,
    tiny negative, past 1, non-finite) and levels (below 1 and L = 1, past
    256 and L = 256, non-finite)."""
    rng = np.random.default_rng(seed)
    n, nt = 4000, 3
    textures = rng.integers(0, 1 << 24, (nt, 512, 512)).astype(np.uint32)
    uv = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    level = np.exp(rng.uniform(-1.0, 7.0, (n, 2))).astype(np.float32)
    uv[:10] = [[np.nan, 0.5], [np.inf, -np.inf], [-0.0, 1.0], [-1e-9, -1e-7],
               [1e30, -1e30], [0.25, 0.75], [0.5, np.nan], [-np.inf, 2.0],
               [-1e-9, 0.999999], [0.0, -0.5]]
    level[:10] = [[np.nan, 1.0], [np.inf, -np.inf], [0.0, 256.0], [256.0, 1.0],
                  [3.0, 64.0], [1e9, 2.0], [np.nan, np.inf], [-5.0, 17.0],
                  [300.0, 0.5], [1.0, 256.0]]
    tex_idx = rng.integers(-1, nt + 1, n).astype(np.int32)
    ref = np.asarray(jtexture.sample_ripmap_bilinear(
        jnp.asarray(textures), jnp.asarray(tex_idx), jnp.asarray(uv),
        jnp.asarray(level)))
    args = (torch.from_numpy(tex_idx), torch.from_numpy(uv),
            torch.from_numpy(level))
    ours = ttexture.sample_ripmap_bilinear(
        torch.from_numpy(textures.view(np.int32)), *args)
    assert np.isfinite(ours.numpy()).all()
    # Channels are at most 255, where one f32 ULP is 1.5e-5: a few ULPs of
    # XLA's operation order, no more.
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-3)
    idx, w = ttexture.bilinear_taps(*args, nt)
    # Row 8 samples u at L = 256 and v at L = 1. At L = 1 both taps of the
    # axis are the level's one texel.
    x = idx.numpy() % 512
    y = idx.numpy() // 512 % 512
    np.testing.assert_array_equal(y[8, 0], y[8, 2])
    assert y[8, 0] == level_offset(1)
    # A tiny negative u wraps to 1.0 at L = 256: t = 255.5, taps 255 and 0.
    np.testing.assert_array_equal(x[8, :2], [255, 0])
    assert float(w[8, 0]) == 0.5


def unit_atlas(fill):
    atlas = np.zeros((512, 512, 3), np.uint8)
    fill(atlas)
    return torch.from_numpy(pack_rgb_words(atlas).astype(np.uint32)
                            .view(np.int32)[None])


def test_sampler_blends_neighbors():
    """tests/test_bilinear.py's unit case on the port's sampler: a 50/50
    blend between two texels, and a texel center equal to nearest."""
    off = level_offset(4)

    def step(atlas):
        atlas[off: off + 4, off + 2: off + 4, 0] = 200

    textures = unit_atlas(step)
    lv = torch.tensor([[4.0, 4.0]])
    tex = torch.zeros(1, dtype=torch.int32)
    rgb = ttexture.sample_ripmap_bilinear(textures, tex,
                                          torch.tensor([[0.5, 0.5]]), lv)
    assert abs(float(rgb[0, 0]) - 100.0) < 1e-3
    uv_c = torch.tensor([[(0.5 + 1) / 4, (0.5 + 1) / 4]])
    near = ttexture.sample_ripmap(textures, tex, uv_c, lv)
    bil = ttexture.sample_ripmap_bilinear(textures, tex, uv_c, lv)
    np.testing.assert_allclose(bil.numpy(), near.numpy(), atol=1e-4)


def test_sampler_wraps():
    """tests/test_bilinear.py's wrap case: u = 0 at level 2 blends texels 1
    and 0 of the level."""
    off = level_offset(2)

    def two_texels(atlas):
        atlas[off: off + 2, off, 1] = 100
        atlas[off: off + 2, off + 1, 1] = 200

    rgb = ttexture.sample_ripmap_bilinear(
        unit_atlas(two_texels), torch.zeros(1, dtype=torch.int32),
        torch.tensor([[0.0, 0.25]]), torch.tensor([[2.0, 2.0]]))
    assert abs(float(rgb[0, 1]) - 150.0) < 1e-3


@pytest.mark.parametrize("name,steps", [("icosahedron", 1), ("anisotropic", 0)])
def test_bilinear_frame_matches_pallas_and_golden(name, steps):
    """The port's bilinear frame (plain flat kernel) against the Pallas
    renderer (interpret mode) and golden: the icosahedron one flight step in,
    the anisotropic scene's shallow-angle textures from the identity camera.
    Both frames are textured, so bilinear differs from nearest."""
    scene = SCENES[name](seed=0)
    jdev, tdev = both_devices(scene)
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    for _ in range(steps):
        m = cam.update(Input(up=1.0, mouse=(8.0, 4.0)))
    px, depth = port_frame(tdev, m)
    ref_px, ref_depth = (np.asarray(a) for a in render_frame_pallas(
        jdev, jnp.asarray(m, jnp.float32), width=W, height=H,
        config=JAX_BILINEAR, interpret=True, tile_h=8))
    gp, _ = golden_render(scene, m, W, H, config=JAX_BILINEAR)
    assert_matches_pallas_and_golden(px, depth, ref_px, ref_depth, gp, name)
    near, _ = port_frame(tdev, m, config=port.DEFAULT_CONFIG)
    assert (px != near).mean() > 0.01, name


def test_segmented_bilinear_frame_matches_pallas_and_golden():
    """stress_scene(objects=128), 3,078 slots: the port's segmented bilinear
    frame against the Pallas kernel's segmented single pass and golden."""
    scene = stress_scene(seed=0, objects=128)
    jdev, tdev = both_devices(scene)
    m = Camera().update(Input(), force_update=True)
    before = tr.raster_segmented_bilinear.launches
    px, depth = port_frame(tdev, m)
    assert tr.raster_segmented_bilinear.launches == before   # plain on CPU
    ref_px, ref_depth = (np.asarray(a) for a in render_frame_pallas(
        jdev, jnp.asarray(m, jnp.float32), width=W, height=H,
        config=JAX_BILINEAR, interpret=True, tile_h=8))
    gp, _ = golden_render(scene, m, W, H, config=JAX_BILINEAR)
    assert_matches_pallas_and_golden(px, depth, ref_px, ref_depth, gp,
                                     "stress128")
    assert (depth > 0).mean() > 0.2


def test_segmented_plain_equals_flat_plain_bilinear_on_default():
    """With bilinear sampling the segmented plain version gives the flat
    one's frame bit for bit, at 3 poses of bench.py's flight."""
    dev = scene_to_device(PORT_SCENES["default"](seed=0), "cpu")
    cam = port.Camera()
    w, h = W, H
    for i in range(3):
        m = cam.update(port.Input(up=1.0, mouse=(2.0 * i, 0.0)),
                       force_update=(i == 0))
        setup = build_setup(dev, torch.as_tensor(m), width=w, height=h,
                            config=BILINEAR)
        trf, tri = tr.pack_setup_tables(setup)
        ids, counts = tr.bin_triangles(setup, width=w, height=h,
                                       tile_h=tr.TILE_H, tile_w=tr.TILE_W)
        kw = dict(width=w, height=h, background=BG)
        pf, df = tr.raster_flat_bilinear_plain(counts, ids, trf, tri,
                                               dev["textures"], **kw)
        ps, ds = tr.raster_segmented_bilinear_plain(
            *tr.bin_segments(setup, width=w, height=h), trf, tri,
            tr.pack_slot_records(setup), dev["textures"], **kw)
        assert torch.equal(ps, pf) and torch.equal(ds, df)
        pn, _ = tr.raster_flat_nearest_plain(counts, ids, trf, tri,
                                             dev["textures"], **kw)
        assert bool((pf != pn).any())
