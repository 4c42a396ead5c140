"""The port's renderer (swift3drenderer_tpu_torch.Renderer on device="cpu")
held against the JAX package's renderers and the golden oracle, plus the
port's import and device rules.

Bounds: pixel mismatch < 5e-4 at tol 1 against the JAX Pallas path (default
scene) and XLA path (the other scene families) — the bound
test_pallas_matches_xla keeps between the JAX package's own two paths — with
depth rtol 1e-4 where both are drawn; < 0.2 % against golden.render_frame.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu.camera import Camera, Input
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES
from swift3drenderer_tpu.renderer import Renderer as JaxRenderer
from swift3drenderer_tpu.renderer import scene_to_device as jscene_to_device
from swift3drenderer_tpu_torch.config import RenderConfig
from swift3drenderer_tpu_torch.convert import device_arrays_from_numpy
from swift3drenderer_tpu_torch.models import SCENES as PORT_SCENES
from swift3drenderer_tpu_torch.models import scene as port_scene
from swift3drenderer_tpu_torch.renderer import scene_to_device

from conftest import pixel_mismatch_fraction

# One intra-op thread a process: the suite runs one pytest worker per core,
# and torch's default of a thread per core in each worker oversubscribes
# the CPU several times over.
torch.set_num_threads(1)

W, H = 320, 240


def assert_frames_match(px, depth, ref_px, ref_depth, what):
    assert px.dtype == np.uint32 and px.shape == (H, W), what
    assert pixel_mismatch_fraction(px, ref_px, tol=1) < 5e-4, what
    both = (ref_depth > 0) & (depth > 0)
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4,
                               err_msg=what)


def poses():
    """The identity camera (test_pallas_matches_xla's pose) and two steps of
    a turning flight."""
    cam = Camera()
    return [cam.update(Input(up=float(step > 0), mouse=(8.0 * step, 0.0)),
                       force_update=(step == 0)).copy() for step in range(3)]


def test_renderer_matches_jax_pallas_and_golden_on_default():
    scene = SCENES["default"](seed=0)
    ours = port.Renderer(scene, device="cpu")
    ref = JaxRenderer(scene, backend="pallas")   # interpret mode on CPU
    for i, m in enumerate(poses()):
        px, depth = ours.render(m, W, H)
        ref_px, ref_depth = ref.render(m, W, H)
        assert_frames_match(px, depth, ref_px, ref_depth, f"pose {i}")
        gp, _ = golden_render(scene, m, W, H)
        assert pixel_mismatch_fraction(px, gp, tol=1) < 0.002, f"pose {i}"
        assert (px != 0x1E1E1E).mean() > 0.2     # the frame is not empty


@pytest.mark.parametrize("name", ["tetrahedron", "icosahedron", "anisotropic",
                                  "clipping"])
def test_renderer_matches_jax_xla_and_golden(name):
    scene = SCENES[name](seed=0)
    m = Camera().update(Input(), force_update=True)
    px, depth = port.Renderer(scene, device="cpu").render(m, W, H)
    ref_px, ref_depth = JaxRenderer(scene, backend="xla").render(m, W, H)
    assert_frames_match(px, depth, ref_px, ref_depth, name)
    gp, _ = golden_render(scene, m, W, H)
    assert pixel_mismatch_fraction(px, gp, tol=1) < 0.002, name


def test_renderer_clipping_flight_matches_golden():
    # Flying through the clipping scene drives the near-plane split path.
    scene = SCENES["clipping"](seed=0)
    ours = port.Renderer(scene, device="cpu")
    cam = Camera()
    for step in range(6):
        m = cam.update(Input(up=2.0), force_update=(step == 0))
        px, _ = ours.render(m, 160, 120)
        gp, _ = golden_render(scene, m, 160, 120)
        assert pixel_mismatch_fraction(px, gp, tol=1) < 0.002, step


@pytest.mark.parametrize("name", ["default", "clipping"])
def test_device_arrays_from_numpy_round_trip(name):
    scene = SCENES[name](seed=0)
    jdev = {k: np.asarray(v) for k, v in jscene_to_device(scene).items()}
    converted = device_arrays_from_numpy(jdev, "cpu")
    built = scene_to_device(PORT_SCENES[name](seed=0), "cpu")
    assert set(converted) == set(built)
    for k in built:
        assert converted[k].dtype == built[k].dtype, k
        assert torch.equal(converted[k], built[k]), k
    np.testing.assert_array_equal(
        converted["textures"].numpy().view(np.uint32), jdev["textures"])


def test_port_scenes_equal_jax_scenes(monkeypatch):
    # stress at a small field; stress100k is not built here (100k
    # triangles), only shown to be stress at 8400 objects.
    small = {"stress": dict(objects=12)}
    for name in PORT_SCENES:
        if name == "stress100k":
            continue
        kw = small.get(name, {})
        a, b = SCENES[name](seed=3, **kw), PORT_SCENES[name](seed=3, **kw)
        for field in ("vertices", "vertex_indices", "normals", "attr_vec",
                      "attr_tex", "attribute_indices", "textures"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                          err_msg=f"{name}.{field}")
    calls = []
    monkeypatch.setattr(port_scene, "stress_scene",
                        lambda **kw: calls.append(kw) or "field")
    assert PORT_SCENES["stress100k"](seed=3) == "field"
    assert calls == [dict(seed=3, objects=8400, textures=None)]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import swift3drenderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'swift3drenderer_tpu')\n"
        "       or n.startswith(('jax.', 'swift3drenderer_tpu.'))]\n"
        "print(len([n for n in sys.modules if n.startswith('swift3drenderer_tpu_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 16   # every module was imported


def test_renderer_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = PORT_SCENES["tetrahedron"](seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.Renderer(scene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.Renderer(scene, device="cuda")


def test_renderer_rejects_what_waits_for_later_slices():
    scene = PORT_SCENES["tetrahedron"](seed=0)
    m = Camera().update(Input(), force_update=True)
    # Bilinear sampling renders now; the tetrahedron is flat-coloured, so its
    # frame is the nearest frame.
    bilinear = port.Renderer(scene, config=RenderConfig(sampling="bilinear"),
                             device="cpu")
    pb, db = bilinear.render(m, W, H)
    # 513 copies of the tetrahedron, 2052 triangles, make 4104 slots, past
    # the JAX package's single-pass 4096: the port renders them in one pass.
    # Copies tie in depth, so the first copy wins every pixel: the frame is
    # the one tetrahedron's.
    big = port.Scene(
        vertices=scene.vertices, normals=scene.normals,
        attr_vec=scene.attr_vec, attr_tex=scene.attr_tex,
        vertex_indices=np.tile(scene.vertex_indices, 513),
        attribute_indices=np.tile(scene.attribute_indices, 513),
        textures=scene.textures)
    px, depth = port.Renderer(big, device="cpu").render(m, W, H)
    p1, d1 = port.Renderer(scene, device="cpu").render(m, W, H)
    np.testing.assert_array_equal(px, p1)
    np.testing.assert_array_equal(depth, d1)
    np.testing.assert_array_equal(pb, p1)
    np.testing.assert_array_equal(db, d1)
    assert (depth > 0).mean() > 0.05


def test_renderer_matches_jax_compact_early_multipass_on_stress():
    """stress_scene(objects=220): 2,643 triangles, 5,286 slots, which the
    JAX package renders through its compact-early multipass (prelive cull,
    chunked clip and setup, live-compacted passes merged by depth) and the
    port in one segmented pass. The JAX side is the Pallas renderer's own
    path, render_frame_pallas, with 8-row tiles (winners do not depend on the
    tiling; the short tiles keep the interpret-mode compile to seconds). The
    second pose puts near-plane straddlers in view."""
    from swift3drenderer_tpu.ops.raster_pallas import render_frame_pallas

    w, h = 160, 120
    scene = SCENES["stress"](seed=0, objects=220)
    assert 2 * scene.num_triangles == 5286
    ours = port.Renderer(scene, device="cpu")
    ref = JaxRenderer(scene, backend="pallas")
    cam = Camera()
    for i, m in enumerate([cam.update(Input(), force_update=True).copy(),
                           cam.update(Input(up=2.0, mouse=(0.0, -40.0)))]):
        px, depth = ours.render(m, w, h)
        ref_px, ref_depth = (np.asarray(a) for a in render_frame_pallas(
            ref.dev, jnp.asarray(m, jnp.float32), width=w, height=h,
            interpret=True, tile_h=8))
        assert pixel_mismatch_fraction(px, ref_px, tol=1) < 5e-4, i
        np.testing.assert_array_equal(depth > 0, ref_depth > 0)
        both = (ref_depth > 0) & (depth > 0)
        np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4)
        gp, _ = golden_render(scene, m, w, h)
        assert pixel_mismatch_fraction(px, gp, tol=1) < 0.002, i
        assert pixel_mismatch_fraction(ref_px, gp, tol=1) < 0.002, i
        assert (depth > 0).mean() > 0.2, i

