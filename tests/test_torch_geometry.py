"""The port's geometry front-end (swift3drenderer_tpu_torch.ops.vertex, .clip,
.setup and renderer.build_setup) held against the JAX package's, on CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Float outputs agree to rtol 1e-5 / atol 1e-6 where both are finite (the two
frameworks round a handful of operations differently: XLA on the CPU contracts
multiply-adds, PyTorch's eager ops do not); masks, texture ids and the integer
bbox agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import DEFAULT_CONFIG
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops import clip as jclip
from swift3drenderer_tpu.ops import setup as jsetup
from swift3drenderer_tpu.ops import vertex as jvertex
from swift3drenderer_tpu.renderer import build_setup as jbuild_setup
from swift3drenderer_tpu.renderer import scene_to_device as jscene_to_device
from swift3drenderer_tpu_torch.convert import device_arrays_from_numpy
from swift3drenderer_tpu_torch.ops import clip as tclip
from swift3drenderer_tpu_torch.ops import setup as tsetup
from swift3drenderer_tpu_torch.ops import vertex as tvertex
from swift3drenderer_tpu_torch.renderer import build_setup as tbuild_setup

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
EXACT_KEYS = {"live", "tex", "is_tex", "xmin", "xmax", "ymin", "ymax", "valid"}
W, H = 320, 240


def assert_close_where_finite(port, ref, name):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin, err_msg=name)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=ATOL,
                               err_msg=name)


def assert_dicts_match(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        p, r = port[k].numpy(), np.asarray(ref[k])
        if k in EXACT_KEYS:
            np.testing.assert_array_equal(p, r, err_msg=k)
        else:
            assert_close_where_finite(p, r, k)


def random_camera_triangles(seed, t=256):
    """Random camera-space triangles around the near plane (z in [-3, 0.5],
    so many straddle near = 0.1 or lie behind it), plus their attributes."""
    rng = np.random.default_rng(seed)
    cv = np.stack([rng.uniform(-4, 4, (t, 3)), rng.uniform(-4, 4, (t, 3)),
                   rng.uniform(-3.0, 0.5, (t, 3))], axis=-1).astype(np.float32)
    attr = rng.uniform(0, 255, (t, 3, 3)).astype(np.float32)
    n = rng.normal(size=(t, 3, 3)).astype(np.float32)
    tex = rng.integers(-1, 2, t).astype(np.int32)
    return cv, attr, n, tex


def test_vertex_stage_matches_jax():
    rng = np.random.default_rng(7)
    verts = np.concatenate([rng.uniform(-20, 20, (300, 3)),
                            np.ones((300, 1))], axis=1).astype(np.float32)
    norms = np.concatenate([rng.normal(size=(300, 3)),
                            np.zeros((300, 1))], axis=1).astype(np.float32)
    m = rng.normal(size=(3, 4)).astype(np.float32)
    factor = DEFAULT_CONFIG.factor(H)
    cv_j = jvertex.transform_points(jnp.asarray(verts), jnp.asarray(m))
    cv_t = tvertex.transform_points(torch.from_numpy(verts), torch.from_numpy(m))
    assert_close_where_finite(cv_t.numpy(), cv_j, "cv")
    # project on identical camera-space input
    rv_j = jvertex.project(cv_j, factor, W / 2.0, H / 2.0)
    rv_t = tvertex.project(torch.from_numpy(np.array(cv_j)), factor,
                           W / 2.0, H / 2.0)
    assert_close_where_finite(rv_t.numpy(), rv_j, "rv")
    n_j = jvertex.transform_normals(jnp.asarray(norms), jnp.asarray(m))
    n_t = tvertex.transform_normals(torch.from_numpy(norms),
                                    torch.from_numpy(m))
    assert_close_where_finite(n_t.numpy(), n_j, "n")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_and_setup_match_jax_on_random_straddlers(seed):
    cv, attr, n, tex = random_camera_triangles(seed)
    factor = DEFAULT_CONFIG.factor(H)
    rv = np.asarray(jvertex.project(jnp.asarray(cv), factor, W / 2.0, H / 2.0))
    kw = dict(near=DEFAULT_CONFIG.near, factor=factor, half_w=W / 2.0,
              half_h=H / 2.0)
    cj = jclip.clip_prepass(jnp.asarray(cv), jnp.asarray(rv), jnp.asarray(attr),
                            jnp.asarray(n), jnp.asarray(tex), **kw)
    ct = tclip.clip_prepass(torch.from_numpy(cv), torch.from_numpy(rv),
                            torch.from_numpy(attr), torch.from_numpy(n),
                            torch.from_numpy(tex), **kw)
    assert_dicts_match(ct, cj)
    valid = np.asarray(cj["valid"])
    front = (rv[..., 2] > DEFAULT_CONFIG.near).sum(axis=1)
    assert ((front == 1) | (front == 2)).sum() > 50     # straddlers present
    assert valid[1::2].any()                            # some split triangles

    # Setup on identical corners, so only its own rounding can differ.
    corners_np = {k: np.asarray(v) for k, v in cj.items()}
    sj = jsetup.triangle_setup({k: jnp.asarray(v) for k, v in corners_np.items()},
                               W, H, DEFAULT_CONFIG.min_area)
    st = tsetup.triangle_setup({k: torch.from_numpy(v)
                                for k, v in corners_np.items()},
                               W, H, DEFAULT_CONFIG.min_area)
    assert_dicts_match(st, sj)
    assert np.asarray(sj["live"]).sum() > 10


@pytest.mark.parametrize("scene_name", ["default", "clipping"])
def test_build_setup_matches_jax_over_flight(scene_name):
    scene = SCENES[scene_name](seed=0)
    jdev = jscene_to_device(scene)
    tdev = device_arrays_from_numpy({k: np.asarray(v) for k, v in jdev.items()},
                                    "cpu")
    cam = Camera()
    for step in range(3):
        m = cam.update(Input(up=2.0), force_update=(step == 0)).copy()
        sj = jbuild_setup(jdev, jnp.asarray(m), width=W, height=H,
                          config=DEFAULT_CONFIG)
        st = tbuild_setup(tdev, torch.from_numpy(m), width=W, height=H,
                          config=DEFAULT_CONFIG)
        assert_dicts_match(st, sj)
        assert np.asarray(sj["live"]).any()


def test_trunc_i32_saturates_like_xla():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, -2.7, 2.7, 2147483520.0,
                  -0.5], np.float32)
    np.testing.assert_array_equal(
        tsetup.trunc_i32(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.int32)))
