"""The port's bucketed live resize and scene animation on the CPU:
``renderer.bucket_dims``, ``Renderer.render(..., bucketed=True)`` (the frame
rendered at its bucket's raster extent with the true size in 0-dim tensors,
``render_frames_bucketed``, then cropped) and ``Renderer.update_scene``, held
against the port's exact-size frames bit for bit and against the JAX
package's bucketed frames (tests/test_resize.py, test_jax_renderer.py's
``test_scene_animation_update``).

Bounds against the JAX package: pixel mismatch < 5e-4 at tol 1 and depth
rtol 1e-4 where both are drawn (test_pallas_matches_xla's bound between the
JAX package's own two paths), except against the XLA backend at
test_resize's identity pose (see that test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu import renderer as jrenderer
from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops.raster_pallas import rasterize_pallas
from swift3drenderer_tpu_torch import renderer as trenderer
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES

from conftest import pixel_mismatch_fraction

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

SIZES = [(320, 240), (300, 200), (333, 217), (512, 384)]   # test_resize's


def poses():
    """The identity camera (test_resize's pose) and one turning step."""
    cam = Camera()
    return [cam.update(Input(), force_update=True).copy(),
            cam.update(Input(up=1.0, mouse=(6.0, -3.0))).copy()]


def assert_within_jax_bound(px, depth, ref_px, ref_depth, what):
    assert px.shape == ref_px.shape, what
    assert pixel_mismatch_fraction(px, ref_px, tol=1) < 5e-4, what
    both = (ref_depth > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4,
                               err_msg=what)


def test_bucket_dims_match_jax():
    for h in (64, 65, 200, 445, 1080, 2160):
        for w in range(100, 4000, 10):
            assert trenderer.bucket_dims(w, h) == jrenderer.bucket_dims(w, h)


def test_frame_dims_round_factor_once():
    dims = trenderer.frame_dims(333, 217)
    assert dims.dtype == np.float32
    np.testing.assert_array_equal(
        dims, np.float32([333, 217, DEFAULT_CONFIG.factor(217), 166.5, 108.5]))


@pytest.fixture(scope="module")
def default_renderers():
    scene = SCENES["default"](seed=0)
    return (port.Renderer(PORT_SCENES["default"](seed=0), device="cpu"),
            jrenderer.Renderer(scene, backend="xla"))


def test_bucketed_frame_equals_exact_frame(default_renderers):
    ours, _ = default_renderers
    for m in poses():
        for w, h in SIZES:
            exact_px, exact_d = ours.render(m, w, h)
            buck_px, buck_d = ours.render(m, w, h, bucketed=True)
            assert buck_px.shape == (h, w) and buck_px.dtype == np.uint32
            np.testing.assert_array_equal(buck_px, exact_px)
            np.testing.assert_array_equal(buck_d, exact_d)
            assert (exact_px != DEFAULT_CONFIG.background_packed).mean() > 0.2


def test_bucketed_frame_pads_with_background():
    """The bucket's raster extent past the true size holds no coverage."""
    scene = PORT_SCENES["default"](seed=0)
    dev = trenderer.scene_to_device(scene, "cpu")
    w, h = 333, 217
    bw, bh = trenderer.bucket_dims(w, h)
    ms = torch.from_numpy(np.stack(poses()))
    pix, depth = trenderer.render_frames_bucketed(
        dev, ms, torch.from_numpy(trenderer.frame_dims(w, h)), bw=bw, bh=bh)
    assert tuple(pix.shape) == (2, bh, bw)
    bg = DEFAULT_CONFIG.background_packed
    assert bool((pix[:, h:] == bg).all() and (pix[:, :, w:] == bg).all())
    assert bool((depth[:, h:] == 0).all() and (depth[:, :, w:] == 0).all())
    ep, ed = trenderer.render_frames(dev, ms, width=w, height=h)
    assert torch.equal(pix[:, :h, :w], ep) and torch.equal(depth[:, :h, :w], ed)


def test_bucketed_frame_matches_jax_xla_bucketed(default_renderers):
    """test_resize's pose and sizes against ``Renderer(backend="xla")``'s
    bucketed frames: the same coverage, depth within rtol 1e-4, and the
    port within golden's 0.2 %. The pixel bound of 5e-4 at tol 1 does not
    hold here: at 300x200, 333x217 and 512x384 this pose puts floor pixels
    on texel boundaries, where XLA's CPU multiply-add contraction and its
    banded rasterizer each flip texels (9.8e-4 to 2.3e-3 against the port;
    the JAX package's own Pallas and XLA frames differ by up to 8.6e-4
    there, and the XLA frame is 2.2e-3 from golden at 333x217). Without
    contraction the port equals the Pallas frame at this pose
    (test_identity_pose_equals_pallas_without_fma). Run with -s for the
    numbers."""
    ours, ref = default_renderers
    scene = SCENES["default"](seed=0)
    m = poses()[0]
    for w, h in SIZES:
        px, depth = ours.render(m, w, h, bucketed=True)
        ref_px, ref_depth = ref.render(m, w, h, bucketed=True)
        gp, _ = golden_render(scene, m, w, h)
        print(f"{w}x{h}: port vs xla {pixel_mismatch_fraction(px, ref_px)}, "
              f"port vs golden {pixel_mismatch_fraction(px, gp)}, xla vs "
              f"golden {pixel_mismatch_fraction(ref_px, gp)}")
        assert px.shape == ref_px.shape == (h, w)
        np.testing.assert_array_equal(depth > 0, ref_depth > 0)
        both = depth > 0
        np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4)
        assert pixel_mismatch_fraction(px, gp, tol=1) < 0.002, (w, h)


def test_bucketed_frame_matches_jax_pallas_bucketed():
    """The tetrahedron at 320x250 (test_bucketed_pallas_backend's frame)
    against the JAX package's bucketed Pallas frame in interpret mode:
    ``_render_frame_bucketed``'s Pallas branch (the true size traced,
    rasterized at the bucket, cropped) at 8-row tiles, which keep the
    interpret-mode compile to seconds (winners do not depend on the
    tiling)."""
    w, h = 320, 250
    bw, bh = jrenderer.bucket_dims(w, h)
    jdev = jrenderer.scene_to_device(SCENES["tetrahedron"](seed=0))
    m = poses()[0]

    @jax.jit
    def bucketed(dev, m, dims):
        setup = jrenderer.build_setup(dev, m, width=dims[0], height=dims[1],
                                      config=DEFAULT_CONFIG,
                                      proj=(dims[2], dims[3], dims[4]))
        return rasterize_pallas(setup, dev["textures"], width=bw, height=bh,
                                background=DEFAULT_CONFIG.background_packed,
                                interpret=True, tile_h=8)

    dims = jnp.asarray([w, h, DEFAULT_CONFIG.factor(h), w / 2.0, h / 2.0],
                       jnp.float32)
    ref_px, ref_depth = (np.asarray(a)[:h, :w]
                         for a in bucketed(jdev, jnp.asarray(m), dims))
    ours = port.Renderer(PORT_SCENES["tetrahedron"](seed=0), device="cpu")
    px, depth = ours.render(m, w, h, bucketed=True)
    assert_within_jax_bound(px, depth, ref_px, ref_depth, "tetrahedron")
    assert (depth > 0).mean() > 0.05


def test_update_scene_matches_jax_animation():
    """test_scene_animation_update on the port: the moved frame differs,
    equals a fresh renderer's on the moved scene (exact and bucketed), and
    the JAX renderer's after its own update_scene; a wrong shape raises."""
    m = poses()[0]
    w, h = 128, 96
    scene = PORT_SCENES["tetrahedron"](seed=0)
    ours = port.Renderer(scene, device="cpu")
    ref = jrenderer.Renderer(SCENES["tetrahedron"](seed=0), backend="xla")
    before, _ = ours.render(m, w, h)
    moved = scene.vertices.copy()
    moved[:, 0] += 2.0                           # slide the tetrahedron right
    normals = scene.normals[::-1].copy()
    ours.update_scene(vertices=moved, normals=normals)
    ref.update_scene(vertices=moved, normals=normals)
    after, after_d = ours.render(m, w, h)
    assert not np.array_equal(before, after)
    fresh = port.Renderer(dataclasses.replace(scene, vertices=moved,
                                              normals=normals), device="cpu")
    fresh_px, fresh_d = fresh.render(m, w, h)
    np.testing.assert_array_equal(after, fresh_px)
    np.testing.assert_array_equal(after_d, fresh_d)
    buck_px, _ = ours.render(m, w, h, bucketed=True)
    np.testing.assert_array_equal(buck_px, fresh_px)
    assert_within_jax_bound(after, after_d, *ref.render(m, w, h), "moved")
    for kw in (dict(vertices=moved[:2]), dict(normals=normals[:, :3]),
               dict(attr_vec=scene.attr_vec[1:])):
        with pytest.raises(ValueError, match="shape"):
            ours.update_scene(**kw)
    np.testing.assert_array_equal(ours.render(m, w, h)[0], after)
