"""The port's native backend (``swift3drenderer_tpu_torch.native``, the C++
core of ``native/`` built by the port into its own ``_build/``) held against
the JAX package's bindings of the same core (``native/build/``, which
tests/conftest.py builds with ``make -C native``).

Both libraries are built from the same sources with the same flags on this
machine, so frames and camera matrices must be equal bit for bit. Golden
bounds are tests/test_native.py's (pixel mismatch at tol 1: 0.2 % on the
default scene, 0.4 % on the clipping flight, 0.3 % bilinear).
"""

import dataclasses
import importlib.util
import inspect
import os
import struct

import numpy as np
import pytest
import torch

from swift3drenderer_tpu.camera import Camera as JaxCamera
from swift3drenderer_tpu.camera import Input as JaxInput
from swift3drenderer_tpu.golden import render_frame as golden_render
from swift3drenderer_tpu.models import SCENES as JAX_SCENES
from swift3drenderer_tpu import native as jax_native
from swift3drenderer_tpu_torch import Camera, Input, RenderConfig, Renderer
from swift3drenderer_tpu_torch import native
from swift3drenderer_tpu_torch.app import FrameLoop, scripted_inputs
from swift3drenderer_tpu_torch.models import SCENES
from swift3drenderer_tpu_torch.renderer import render_frames
from swift3drenderer_tpu_torch.tools import native_baseline
from swift3drenderer_tpu_torch.utils.databin import dump_scene

from conftest import pixel_mismatch_fraction

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BILINEAR = RenderConfig(sampling="bilinear")


@pytest.fixture()
def both(native_lib):
    """Both packages' bindings loaded: the JAX package's library from
    ``make -C native`` (skips where the toolchain failed) and the port's
    own build."""
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library is not built")
    assert native.native_available()
    return jax_native, native


def identity():
    return Camera().update(Input(), force_update=True)


def test_port_builds_its_own_library(both):
    """The port's library lies in its _build/, hashed, not in native/build/,
    and its name follows the sources and the flags."""
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libs3dnative-")
    assert os.path.exists(path)
    assert native.build() == ""          # current: nothing compiled again
    assert "-ffp-contract=off" in native.CXXFLAGS
    assert "-march=native" in native.CXXFLAGS


@pytest.mark.parametrize("case", ["default", "clipping", "bilinear"])
def test_native_frames_equal_jax_native(both, case):
    """The port's NativeRenderer gives the JAX NativeRenderer's frames bit
    for bit, at tests/test_native.py's sizes and poses, and stays within
    golden's bound."""
    jn, pn = both
    name = "clipping" if case == "clipping" else "default"
    config = BILINEAR if case == "bilinear" else RenderConfig()
    jconfig = dataclasses.replace(jn.DEFAULT_CONFIG, sampling=config.sampling)
    ours = pn.NativeRenderer(SCENES[name](seed=0), config=config)
    theirs = jn.NativeRenderer(JAX_SCENES[name](seed=0), config=jconfig)
    if case == "clipping":
        cam = JaxCamera()
        poses = [cam.update(JaxInput(up=2.0), force_update=(i == 0))
                 for i in range(10)]
        size, bound = (160, 120), 0.004
    else:
        poses = [JaxCamera().update(JaxInput(), force_update=True)]
        size, bound = (((160, 120), 0.003) if case == "bilinear"
                       else ((320, 240), 0.002))
    for m in poses:
        px, d = ours.render(m, *size)
        jpx, jd = theirs.render(m, *size)
        assert px.dtype == np.uint32 and px.shape == (size[1], size[0])
        np.testing.assert_array_equal(px, jpx)
        np.testing.assert_array_equal(d, jd)
        gp, gd = golden_render(JAX_SCENES[name](seed=0), m, *size,
                               config=jconfig)
        assert pixel_mismatch_fraction(gp, px, tol=1) < bound
    both_drawn = (gd > 0) & (d > 0)
    np.testing.assert_allclose(d[both_drawn], gd[both_drawn], rtol=1e-4)


def test_native_camera_equals_jax_and_port_camera(both):
    """NativeCamera's matrices equal the JAX NativeCamera's bit for bit and
    the port's Camera within 1e-5."""
    jn, pn = both
    ours, theirs, cam = pn.NativeCamera(), jn.NativeCamera(), Camera()
    for step in range(5):
        kw = dict(up=1.0, right=0.5, mouse=(3.0 * step, -step),
                  force_update=(step == 0))
        m = ours.update(**kw)
        np.testing.assert_array_equal(m, theirs.update(**kw))
        np.testing.assert_allclose(
            m, cam.update(Input(up=1.0, right=0.5, mouse=(3.0 * step, -step)),
                          force_update=(step == 0)), atol=1e-5)


def test_native_scene_io_roundtrip_and_corrupt_scene(both, tmp_path):
    """A data.bin written by the port loads through the native parser
    (counts right) and saves back byte for byte; a scene mixing colour and
    texture, a truncated one and one claiming a huge vertex count raise
    ValueError."""
    _, pn = both
    scene = SCENES["default"](seed=0)
    path = str(tmp_path / "data.bin")
    dump_scene(scene, path)
    lib = pn.load_native()
    handle = pn.load_scene_native(path)
    assert lib.s3d_scene_vertex_count(handle) == 39
    assert lib.s3d_scene_triangle_count(handle) == 51
    assert lib.s3d_scene_texture_count(handle) == 2
    out = str(tmp_path / "resaved.bin")
    assert lib.s3d_scene_save(handle, out.encode()) == 0
    assert open(out, "rb").read() == open(path, "rb").read()
    lib.s3d_scene_free(handle)

    blob = bytearray(dump_scene(scene))
    off = 16 + 39 * 16 + 16 + 154 * 8 + 16  # first attribute record
    blob[off + 32] = 0  # a texture attribute made a colour one
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="mixes color and texture"):
        pn.load_scene_native(str(bad))
    short = tmp_path / "short.bin"
    short.write_bytes(bytes(blob[:40]))
    with pytest.raises(ValueError, match="truncated"):
        pn.load_scene_native(str(short))
    huge = tmp_path / "hugecount.bin"
    huge.write_bytes(struct.pack("<qq", 1 << 40, 0))
    with pytest.raises(ValueError, match="truncated"):
        pn.load_scene_native(str(huge))


def test_renderer_native_backend(both):
    """Renderer(backend="native") renders through the core (its frame equal
    to NativeRenderer's) and holds no device tensors; the device entry
    points and update_scene raise with the JAX messages; the default
    backend stays "cuda", and render_frames takes no "native"."""
    scene = SCENES["tetrahedron"](seed=0)
    m = identity()
    r = Renderer(scene, backend="native")
    assert r.dev is None and r.graphs is None and r.device is None
    px, d = r.render(m, 160, 120)
    np.testing.assert_array_equal(
        px, native.NativeRenderer(scene).render(m, 160, 120)[0])
    gp, _ = golden_render(JAX_SCENES["tetrahedron"](seed=0), m, 160, 120)
    assert pixel_mismatch_fraction(gp, px, tol=1) < 0.002
    with pytest.raises(ValueError, match="native backend renders on host"):
        r.render_device(m, 160, 120)
    with pytest.raises(ValueError, match="native backend renders on host"):
        r.render_batch(np.stack([m, m]), 160, 120)
    with pytest.raises(ValueError, match="requires a device backend"):
        r.update_scene(vertices=scene.vertices)
    assert inspect.signature(Renderer).parameters["backend"].default == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        render_frames({}, torch.zeros(1, 3, 4), width=8, height=8,
                      backend="native")


def test_frame_loop_on_native_equals_renderer(both):
    """A headless FrameLoop on the native backend (buckets off) renders what
    Renderer.render renders at each pose of its flight."""
    scene = SCENES["default"](seed=0)
    loop = FrameLoop(scene, 96, 64, backend="native", bucketed=True)
    assert loop.bucketed is False
    ref = Renderer(scene, backend="native")
    cam = Camera()
    for i, inp in enumerate(scripted_inputs("3:w;3:w mx2", 6)):
        px = loop.step(inp)
        want, _ = ref.render(cam.update(inp, force_update=(i == 0)), 96, 64)
        np.testing.assert_array_equal(px, want)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_native_baseline", os.path.join(REPO, "tools", "native_baseline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_native_baseline_matches_jax_tool(both):
    """The tool's CONFIGS are the JAX tool's, and run_config on the
    tetrahedron flight gives the JAX tool's checksum and fields."""
    tool = _jax_tool()
    assert native_baseline.CONFIGS == tool.CONFIGS
    ours = native_baseline.run_config("tetrahedron", 160, 120, fly=True,
                                      frames=3)
    theirs = tool.run_config("tetrahedron", 160, 120, fly=True, frames=3)
    assert ours.keys() == theirs.keys()
    for key in ("width", "height", "frames", "checksum", "triangles"):
        assert ours[key] == theirs[key], key
    assert ours["fps"] > 0 and ours["checksum"] > 0
    assert os.path.exists(native_baseline.REFERENCE_RESULTS)
