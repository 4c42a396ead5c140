"""The port's second backend, ``ops.raster_xla`` (the JAX package's portable
banded rasterizer in torch ops), and ``Renderer(backend="xla")``, on the CPU.

Bounds against the JAX ``ops.raster_xla.rasterize`` on the same setup table:
pixel mismatch < 5e-4 at tol 1, depth rtol 1e-4 where both are drawn, the
same drawn set. The port normalises with a correctly rounded square root and
contracts nothing; XLA's CPU rsqrt is not correctly rounded and XLA contracts
multiply-adds on a CPU with FMA3, so a pixel on a channel or texel step may
move. Without contraction (a subprocess with XLA limited to AVX) the depth is
bit-equal. Within the port everything is bit for bit: bands, chunks,
batches, buckets.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.config import RenderConfig as JaxConfig
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.ops.raster_xla import rasterize as jax_rasterize
from swift3drenderer_tpu.renderer import build_setup as jax_build_setup
from swift3drenderer_tpu.renderer import scene_to_device as jax_to_device
from swift3drenderer_tpu_torch.config import RenderConfig
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.ops import raster_xla
from swift3drenderer_tpu_torch.renderer import (
    build_setup, render_frame_xla, scene_to_device)

from conftest import pixel_mismatch_fraction

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BG = RenderConfig().background_packed


def turning_poses():
    """Two steps of test_torch_renderer's turning flight (its identity pose
    is a texel-boundary pose under XLA's contraction, ROADMAP queue 3)."""
    cam = Camera()
    cam.update(Input(), force_update=True)
    return [cam.update(Input(up=1.0, mouse=(8.0 * step, 0.0))).copy()
            for step in (1, 2)]


def to_torch(setup):
    return {k: torch.from_numpy(np.array(v)) for k, v in setup.items()}


def port_textures(dev):
    return torch.from_numpy(np.array(dev["textures"]).view(np.int32))


@pytest.fixture(scope="module")
def default_dev():
    return jax_to_device(SCENES["default"](seed=0))


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("size", [(96, 64), (128, 96)])
def test_rasterize_matches_jax_rasterize(default_dev, size, sampling):
    """Both rasterizers on the JAX front-end's table, two poses."""
    w, h = size
    cfg = JaxConfig(sampling=sampling)
    for i, m in enumerate(turning_poses()):
        setup = jax_build_setup(default_dev, jnp.asarray(m), width=w,
                                height=h, config=cfg)
        jp, jd = (np.asarray(a) for a in jax_rasterize(
            setup, default_dev["textures"], width=w, height=h, background=BG,
            sampling=sampling))
        pix, depth = raster_xla.rasterize(
            to_torch(setup), port_textures(default_dev), width=w, height=h,
            background=BG, sampling=sampling)
        pix, depth = pix.numpy().view(np.uint32), depth.numpy()
        what = f"{w}x{h} {sampling} pose {i}"
        np.testing.assert_array_equal(depth > 0, jd > 0, err_msg=what)
        assert (depth > 0).mean() > 0.3, what
        assert pixel_mismatch_fraction(pix, jp, tol=1) < 5e-4, what
        both = depth > 0
        np.testing.assert_allclose(depth[both], jd[both], rtol=1e-4,
                                   err_msg=what)


@pytest.fixture(scope="module")
def port_frame():
    """One port table (default scene, 128x96, second turning pose), its
    textures, and its frame at the default band_rows and chunk."""
    dev = scene_to_device(PORT_SCENES["default"](seed=0), "cpu")
    setup = build_setup(dev, torch.from_numpy(turning_poses()[1]), width=128,
                        height=96, config=RenderConfig())
    return setup, dev["textures"], raster_xla.rasterize(
        setup, dev["textures"], width=128, height=96, background=BG)


@pytest.mark.parametrize("band_rows,chunk", [(1, 1), (7, 5), (96, 128),
                                             (13, 102)])
def test_rasterize_does_not_depend_on_bands_or_chunks(port_frame, band_rows,
                                                      chunk):
    setup, tex, (pix, depth) = port_frame
    p, d = raster_xla.rasterize(setup, tex, width=128, height=96,
                                background=BG, band_rows=band_rows,
                                chunk=chunk)
    assert torch.equal(p, pix) and torch.equal(d, depth)


@pytest.mark.parametrize("y0,rows", [(0, 20), (17, 33), (61, 35)])
def test_band_equals_rows_of_the_frame(port_frame, y0, rows):
    setup, tex, (pix, depth) = port_frame
    p, d = raster_xla.rasterize(setup, tex, width=128, height=rows,
                                background=BG, y_offset=y0, band_rows=8)
    assert torch.equal(p, pix[y0:y0 + rows])
    assert torch.equal(d, depth[y0:y0 + rows])


def test_padded_slots_and_the_chunk_tie_rule():
    """Slots past the table are dead; at equal 1/z the lowest slot wins
    inside a chunk and across chunks (two copies of one triangle)."""
    scene = PORT_SCENES["tetrahedron"](seed=0)
    dev = scene_to_device(scene, "cpu")
    setup = build_setup(dev, torch.from_numpy(turning_poses()[0]), width=64,
                        height=48, config=RenderConfig())
    twice = {k: torch.cat([v, v]) for k, v in setup.items()}
    s = setup["live"].shape[0]
    for chunk in (3, s, 2 * s):
        pix, depth = raster_xla.rasterize(setup, dev["textures"], width=64,
                                          height=48, background=BG,
                                          chunk=chunk)
        p2, d2 = raster_xla.rasterize(twice, dev["textures"], width=64,
                                      height=48, background=BG, chunk=chunk)
        assert torch.equal(pix, p2) and torch.equal(depth, d2)
    assert raster_xla._pad_setup(setup, s) is setup
    padded = raster_xla._pad_setup(setup, 5)
    assert padded["live"].shape[0] % 5 == 0
    assert not padded["live"][s:].any()


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_renderer_xla_backend_is_bit_exact_within_the_port(sampling):
    """Renderer(backend="xla"): render equals render_frame_xla, a batch
    equals its single frames, a bucketed frame the exact one, and
    update_scene moves the next frame as a fresh renderer sees it."""
    cfg = RenderConfig(sampling=sampling)
    scene = PORT_SCENES["default"](seed=0)
    r = port.Renderer(scene, cfg, device="cpu", backend="xla")
    assert r.backend == "xla"
    poses = turning_poses()
    w, h = 96, 64
    singles = [r.render(m, w, h) for m in poses]
    for m, (pix, depth) in zip(poses, singles):
        p, d = render_frame_xla(r.dev, torch.from_numpy(m), width=w, height=h,
                                config=cfg)
        np.testing.assert_array_equal(pix, p.numpy().view(np.uint32))
        np.testing.assert_array_equal(depth, d.numpy())
        pd, dd = r.render_device(m, w, h)
        assert torch.equal(pd, p) and torch.equal(dd, d)
    bp, bd = r.render_batch(np.stack(poses), w, h)
    for b, (pix, depth) in enumerate(singles):
        np.testing.assert_array_equal(bp[b].numpy().view(np.uint32), pix)
        np.testing.assert_array_equal(bd[b].numpy(), depth)
    for size in ((w, h), (75, 50)):
        pe, de = r.render(poses[0], *size)
        pb, db = r.render(poses[0], *size, bucketed=True)
        np.testing.assert_array_equal(pb, pe)
        np.testing.assert_array_equal(db, de)
    moved = scene.vertices.copy()
    moved[:, 1] += 0.25
    r.update_scene(vertices=moved)
    fresh = port.Renderer(
        port.Scene(**{**scene.__dict__, "vertices": moved}), cfg,
        device="cpu", backend="xla")
    np.testing.assert_array_equal(r.render(poses[0], w, h)[0],
                                  fresh.render(poses[0], w, h)[0])


def test_renderer_cuda_and_xla_backends_agree():
    """The two backends of the port on the same device: within the port's
    5e-4 bound and the same drawn set (their shading rounds alike; their
    visibility resolves the same winners)."""
    scene = PORT_SCENES["default"](seed=0)
    cuda = port.Renderer(scene, device="cpu")
    xla = port.Renderer(scene, device="cpu", backend="xla")
    for m in turning_poses():
        pc, dc = cuda.render(m, 128, 96)
        px, dx = xla.render(m, 128, 96)
        np.testing.assert_array_equal(dc > 0, dx > 0)
        assert pixel_mismatch_fraction(pc, px, tol=1) < 5e-4
        np.testing.assert_allclose(dc[dc > 0], dx[dc > 0], rtol=1e-4)


def test_unknown_backend_raises():
    scene = PORT_SCENES["tetrahedron"](seed=0)
    with pytest.raises(ValueError, match="unknown backend"):
        port.Renderer(scene, device="cpu", backend="pallas")
    dev = scene_to_device(scene, "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        port.renderer.render_frames(dev, torch.zeros(1, 3, 4), width=8,
                                    height=8, backend="native")


# The JAX package's whole XLA frame at bench.py's first flight pose, with
# XLA limited to AVX (no multiply-add contraction).
_NO_FMA_XLA_RUN = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_platforms", "cpu")
from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.renderer import render_frame_xla, scene_to_device
dev = scene_to_device(SCENES["default"](seed=0))
m = jnp.asarray(Camera().update(Input(up=1.0), force_update=True))
out = {}
for size in sys.argv[2:]:
    w, h = map(int, size.split("x"))
    pix, depth = render_frame_xla(dev, m, width=w, height=h)
    out[f"pix{size}"], out[f"depth{size}"] = np.asarray(pix), np.asarray(depth)
np.savez(sys.argv[1], **out)
"""


def test_xla_frame_without_fma_has_equal_depth(tmp_path):
    """bench.py's first flight pose on the default scene at 96x64 and
    128x96: the JAX ``render_frame_xla`` without contraction against the
    port's ``Renderer(backend="xla")``. Depth is bit-equal; pixels stay
    within 5e-4 at tol 1 (XLA's rsqrt against the port's correctly rounded
    root)."""
    sizes = ["96x64", "128x96"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-c", _NO_FMA_XLA_RUN, str(tmp_path / "xla.npz"),
         *sizes], env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(tmp_path / "xla.npz")
    ours = port.Renderer(PORT_SCENES["default"](seed=0), device="cpu",
                         backend="xla")
    m = port.Camera().update(port.Input(up=1.0), force_update=True)
    for size in sizes:
        w, h = map(int, size.split("x"))
        pix, depth = ours.render(m, w, h)
        np.testing.assert_array_equal(depth, ref[f"depth{size}"],
                                      err_msg=size)
        assert pixel_mismatch_fraction(pix, ref[f"pix{size}"], tol=1) < 5e-4
        assert (depth > 0).mean() > 0.2, size
