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
from swift3drenderer_tpu_torch.renderer import scene_to_device

from conftest import pixel_mismatch_fraction

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


def test_port_scenes_equal_jax_scenes():
    for name in PORT_SCENES:
        a, b = SCENES[name](seed=3), PORT_SCENES[name](seed=3)
        for field in ("vertices", "vertex_indices", "normals", "attr_vec",
                      "attr_tex", "attribute_indices", "textures"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                          err_msg=f"{name}.{field}")


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
    bilinear = port.Renderer(scene, config=RenderConfig(sampling="bilinear"),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        bilinear.render(m, W, H)
    # 2049 triangles make 4098 slots, past the single-pass 4096.
    big = port.Scene(
        vertices=scene.vertices, normals=scene.normals,
        attr_vec=scene.attr_vec, attr_tex=scene.attr_tex,
        vertex_indices=np.tile(scene.vertex_indices[:3], 2049),
        attribute_indices=np.tile(scene.attribute_indices[:3], 2049),
        textures=scene.textures)
    with pytest.raises(NotImplementedError, match="item 8"):
        port.Renderer(big, device="cpu").render(m, W, H)

