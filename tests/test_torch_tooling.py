"""The port's tooling on the CPU: the joystick parser, the OBJ loader, the
golden oracle's copy, the ripmap samplers, the photo textures, profiling,
the entry hook, and the rule that no module of the port imports JAX or the
JAX package. Each copy is held to the JAX module it copies, bit for bit."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import swift3drenderer_tpu_torch as port
from swift3drenderer_tpu_torch.joystick import (
    JS_EVENT_AXIS, JS_EVENT_BUTTON, JS_EVENT_INIT, JoystickInput, open_joystick)
from swift3drenderer_tpu_torch.utils import ripmap

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVT = struct.Struct("<IhBB")


def test_joystick_parser_matches_jax():
    """The same js_event bytes, fed in ragged pieces, give the same sticks
    and the same Input sequence in both packages."""
    from swift3drenderer_tpu.camera import Input as JaxInput
    from swift3drenderer_tpu.joystick import JoystickInput as JaxJoystick

    rng = np.random.default_rng(11)
    events = b"".join(
        EVT.pack(i, int(rng.integers(-32767, 32768)),
                 int(rng.choice([JS_EVENT_AXIS, JS_EVENT_BUTTON,
                                 JS_EVENT_AXIS | JS_EVENT_INIT])),
                 int(rng.integers(0, 6))) for i in range(64))
    events += EVT.pack(0, 1000, JS_EVENT_AXIS, 0)      # inside the deadzone
    ours, theirs = JoystickInput(path=None), JaxJoystick(path=None)
    a, b = port.Input(), JaxInput()
    cuts = [0, 3, 8, 21, 100, 257, len(events)]
    for lo, hi in zip(cuts, cuts[1:]):
        ours.feed(events[lo:hi])
        theirs.feed(events[lo:hi])
        assert ours._raw == theirs._raw and ours._pending == theirs._pending
        a, b = ours.update_input(a), theirs.update_input(b)
        assert (a.up, a.down, a.left, a.right, a.mouse) == (
            b.up, b.down, b.left, b.right, b.mouse)
    assert ours._raw[0] == 0.0
    assert open_joystick("/nonexistent/js9") is None
    with JoystickInput(path=None) as pad:
        pad.poll()                      # no device: a no-op


CUBE_OBJ = """
o cube
v -1 -1 -1
v  1 -1 -1
v  1  1 -1
v -1  1 -1
v -1 -1  1
v  1 -1  1
v  1  1  1
v -1  1  1
vt 0 0
vt 1 0
vt 1 1
vn  0  0 -1
f 1//1 2//1 3//1 4//1
f 5 8 7 6
g side
f 1/1 5/2 6/3 2/1
f -8/1/1 -4/2/1 -1/3/1
"""


@pytest.mark.parametrize("kw", [{}, {"scale": 0.5, "offset": (0, 0, -4)},
                                {"texture": 0}])
def test_load_obj_matches_jax(kw):
    from swift3drenderer_tpu.utils.objio import load_obj as jax_load_obj
    from swift3drenderer_tpu_torch.models.textures import default_texture_words
    from swift3drenderer_tpu_torch.utils.objio import load_obj

    if "texture" in kw:
        kw = dict(kw, textures=default_texture_words(1))
    ours, theirs = load_obj(CUBE_OBJ, **kw), jax_load_obj(CUBE_OBJ, **kw)
    assert isinstance(ours, port.Scene)
    for field in ("vertices", "vertex_indices", "normals", "attr_vec",
                  "attr_tex", "attribute_indices", "textures"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(theirs, field), err_msg=field)
    with pytest.raises(ValueError, match="no faces"):
        load_obj("v 0 0 0\nv 1 0 0\n")


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_golden_copy_is_bit_equal_to_jax_golden(sampling):
    """The port's golden oracle and the JAX one on the default scene at
    64x48, three poses (one flying through the near plane)."""
    from swift3drenderer_tpu.config import RenderConfig as JaxConfig
    from swift3drenderer_tpu.golden import render_frame as jax_golden
    from swift3drenderer_tpu.models import SCENES as JAX_SCENES
    from swift3drenderer_tpu_torch.config import RenderConfig
    from swift3drenderer_tpu_torch.golden import render_frame
    from swift3drenderer_tpu_torch.models import SCENES

    cam = port.Camera()
    poses = [cam.update(port.Input(up=float(i), mouse=(10.0 * i, 4.0 * i)),
                        force_update=(i == 0)).copy() for i in range(3)]
    for name in ("default", "clipping"):
        ours, theirs = SCENES[name](seed=0), JAX_SCENES[name](seed=0)
        for m in poses:
            p, d = render_frame(ours, m, 64, 48, RenderConfig(sampling=sampling))
            jp, jd = jax_golden(theirs, m, 64, 48, JaxConfig(sampling=sampling))
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(d, jd)
            assert (d > 0).any()


def test_golden_agrees_with_the_renderer():
    from swift3drenderer_tpu_torch.golden import render_frame
    from swift3drenderer_tpu_torch.models import SCENES

    from conftest import pixel_mismatch_fraction

    scene = SCENES["default"](seed=0)
    m = port.Camera().update(port.Input(up=1.0, mouse=(8.0, 0.0)),
                             force_update=True)
    gp, gd = render_frame(scene, m, 96, 64)
    for backend in ("cuda", "xla"):
        pix, depth = port.Renderer(scene, device="cpu",
                                   backend=backend).render(m, 96, 64)
        assert pixel_mismatch_fraction(pix, gp, tol=1) < 0.002
        np.testing.assert_array_equal(depth > 0, gd > 0)


def test_ripmap_samplers_match_jax():
    from swift3drenderer_tpu.utils import ripmap as jax_ripmap
    from swift3drenderer_tpu_torch.models.textures import default_texture_words

    words = default_texture_words(1)[0]
    rng = np.random.default_rng(7)
    uv = rng.uniform(-3, 3, (4000, 2)).astype(np.float32)
    level = rng.uniform(0, 300, (4000, 2)).astype(np.float32)
    uv[:5, 0] = uv[5:10, 1] = [np.nan, np.inf, -np.inf, 0.999999, -1e-9]
    level[5:10, 0] = level[:5, 1] = [np.nan, np.inf, -np.inf, 0.0, 256.0]
    for name in ("sample_ripmap", "sample_ripmap_bilinear"):
        ours = getattr(ripmap, name)(words, uv, level)
        theirs = getattr(jax_ripmap, name)(words, uv, level)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    for x in (1.0, 1.9, 3.7, 4.9, 17.2, 256.0):
        assert ripmap.next_power_of_two(x) == jax_ripmap.next_power_of_two(x)


def test_photo_texture_words_match_jax():
    pytest.importorskip("PIL")
    from swift3drenderer_tpu.models import textures as jax_textures
    from swift3drenderer_tpu_torch.models import textures

    assert textures._photo_sources() == jax_textures._photo_sources()
    try:
        ours = textures.photo_texture_words(2)
    except RuntimeError:
        pytest.skip("no bundled sample photographs on this host")
    np.testing.assert_array_equal(ours, jax_textures.photo_texture_words(2))
    assert ours.shape == (2, 512, 512) and ours.dtype == np.uint32


def test_steady_state_frame_time_and_device_trace(tmp_path):
    from swift3drenderer_tpu_torch.models import SCENES
    from swift3drenderer_tpu_torch.utils.profiling import (
        device_trace, steady_state_frame_time)

    r = port.Renderer(SCENES["tetrahedron"](seed=0), device="cpu")
    cam = port.Camera()
    ms = np.stack([cam.update(port.Input(up=1.0), force_update=(i == 0)).copy()
                   for i in range(4)])
    s = steady_state_frame_time(lambda m: r.render_device(m, 32, 24), ms,
                                trials=2)
    assert 1e-9 <= s < 1.0
    with device_trace(str(tmp_path / "trace")) as prof:
        r.render_device(ms[0], 32, 24)
    assert prof.key_averages()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_entry_renders_the_main_path():
    from swift3drenderer_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    pix = fn(*args)
    assert tuple(pix.shape) == (480, 640) and pix.dtype == torch.int32
    renderer, m = args
    want, _ = renderer.render(m, 640, 480)
    np.testing.assert_array_equal(pix.numpy().view(np.uint32), want)


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import swift3drenderer_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                     pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "swift3drenderer_tpu" or m.startswith("swift3drenderer_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_modules_import_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    neither ``jax`` nor ``swift3drenderer_tpu`` in sys.modules."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.splitlines()[-1])
    for name in ("app", "viewer", "datagen", "joystick", "entry",
                 "golden.renderer", "ops.raster_xla", "utils.objio",
                 "utils.telemetry", "utils.profiling", "utils.ripmap",
                 "examples.compare_backends", "examples.capture_flight"):
        assert f"swift3drenderer_tpu_torch.{name}" in out["modules"], name
    assert out["bad"] == []
