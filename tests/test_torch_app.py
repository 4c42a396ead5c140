"""The port's app shell (``swift3drenderer_tpu_torch.app``) and data
generator on ``device="cpu"``: the counterparts of tests/test_app.py, and the
port held to the JAX modules where both compute the same thing (input
scripts, terminal bytes, checkpoints, ANSI frames, data.bin and atlas bytes).
"""

import os

import numpy as np
import pytest
import torch

from swift3drenderer_tpu_torch.app import (
    FrameLoop, TerminalInput, ansi_frame, main as app_main, run_headless,
    scripted_inputs)
from swift3drenderer_tpu_torch.camera import Input, KeyboardState
from swift3drenderer_tpu_torch.config import DEFAULT_CONFIG
from swift3drenderer_tpu_torch.datagen import main as datagen_main
from swift3drenderer_tpu_torch.models import tetrahedron_scene
from swift3drenderer_tpu_torch.renderer import Renderer
from swift3drenderer_tpu_torch.utils.databin import load_scene
from swift3drenderer_tpu_torch.utils.ppm import read_ppm, write_ppm
from swift3drenderer_tpu_torch.utils.telemetry import FrameStats

torch.set_num_threads(1)

W, H = 64, 48


def loop_of(**kw):
    return FrameLoop(tetrahedron_scene(seed=0), W, H, device="cpu", **kw)


def test_frame_loop_double_buffering():
    loop = loop_of()
    a = loop.step()
    b = loop.step()
    assert a is not b and a.dtype == np.uint32 and a.shape == (H, W)
    c = loop.step()
    assert c is a
    assert loop.frame_index == 3


def test_frame_loop_renders_the_renderers_frame():
    """A step is Renderer.render of the camera's matrix, on either backend."""
    for backend in ("cuda", "xla"):
        loop = loop_of(backend=backend)
        inp = Input(up=1.0, mouse=(5.0, 0.0))
        px = loop.step(inp)
        want, _ = Renderer(tetrahedron_scene(seed=0), device="cpu",
                           backend=backend).render(loop.camera.matrix, W, H)
        np.testing.assert_array_equal(px, want)


def test_frame_loop_resize():
    loop = loop_of()
    loop.step()
    loop.resize(80, 60)
    assert loop.step().shape == (60, 80)
    with pytest.raises(ValueError):
        loop.resize(0, 10)


@pytest.mark.parametrize("bucketed", [False, True])
def test_per_frame_resize_cycling(bucketed):
    sizes = [(64, 48), (96, 72), (80, 60)]
    loop = loop_of(bucketed=bucketed)
    for i in range(6):
        w, h = sizes[i % 3]
        loop.resize(w, h)
        px = loop.step()
        assert px.shape == (h, w)
        assert (px != DEFAULT_CONFIG.background_packed).any()


SCRIPTS = ["2:w;1:s+;2:d mx2", "60:w;60:w mx2", "3:a my-1.5;2:w+mx3my2;;1:"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripted_inputs_match_jax(script):
    from swift3drenderer_tpu.app import scripted_inputs as jax_scripted

    ours = list(scripted_inputs(script, 12))
    theirs = list(jax_scripted(script, 12))
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        assert (a.up, a.down, a.left, a.right, a.mouse) == (
            b.up, b.down, b.left, b.right, b.mouse)


def test_scripted_inputs():
    inputs = list(scripted_inputs("2:w;1:s+;2:d mx2", 10))
    assert inputs[0].up == 1.0 and inputs[2].down == 2.0
    assert inputs[4].mouse[0] == inputs[3].mouse[0] + 2.0
    assert inputs[9].up == 0.0 and inputs[9].mouse == inputs[4].mouse


def test_terminal_input_matches_jax():
    """The same bytes at the same clock give the same KeyboardState and
    Input sequence in both packages."""
    from swift3drenderer_tpu.app import TerminalInput as JaxTerminal
    from swift3drenderer_tpu.camera import Input as JaxInput
    from swift3drenderer_tpu.camera import KeyboardState as JaxKeyboard

    clock = [0.0]
    ours = TerminalInput(KeyboardState(), clock=lambda: clock[0])
    theirs = JaxTerminal(JaxKeyboard(), clock=lambda: clock[0])
    inp_a, inp_b = Input(), JaxInput()
    feeds = [b"w", b"D", b"\x1b[C", b"", b"\x1b[A\x1b[D", b"a", b"c", b"",
             b"S", b"\x1bx", b"q"]
    for i, data in enumerate(feeds):
        ours.feed(data)
        theirs.feed(data)
        clock[0] += 0.07 * (i % 3)
        ours.tick()
        theirs.tick()
        inp_a = ours.keyboard.update_input(inp_a)
        inp_b = theirs.keyboard.update_input(inp_b)
        assert (inp_a.up, inp_a.down, inp_a.left, inp_a.right, inp_a.mouse) \
            == (inp_b.up, inp_b.down, inp_b.left, inp_b.right, inp_b.mouse), i
        for attr in ("mouse_captured", "quit_requested"):
            assert getattr(ours.keyboard, attr) == getattr(theirs.keyboard,
                                                           attr), (i, attr)
    assert ours.keyboard.quit_requested


def test_terminal_input_parser():
    clock = [0.0]
    term = TerminalInput(KeyboardState(), clock=lambda: clock[0])
    term.feed(b"w")
    term.tick()
    assert term.keyboard.update_input(Input()).up == 1.0
    term.feed(b"D")
    term.tick()
    inp = term.keyboard.update_input(Input())
    assert inp.right == 2.0 and inp.up == 2.0
    term.feed(b"\x1b[C")
    inp = term.keyboard.update_input(Input())
    assert term.keyboard.mouse_captured and inp.mouse[0] == 15.0
    clock[0] += term.HOLD_SECONDS * 1.5
    term.tick()
    inp = term.keyboard.update_input(Input())
    assert inp.up == 0.0 and inp.right == 0.0
    term.feed(b"q")
    assert term.keyboard.quit_requested


def test_checkpoint_resume(tmp_path):
    scene = tetrahedron_scene(seed=0)
    ckpt = str(tmp_path / "pose.json")
    run_headless(scene, width=W, height=H, frames=10, script="10:w",
                 checkpoint=ckpt, device="cpu")
    assert os.path.exists(ckpt)
    loop = FrameLoop(scene, W, H, device="cpu")
    loop.load_checkpoint(ckpt)
    assert loop.frame_index == 10
    assert abs(loop.camera.position[2] + 1.0) < 1e-5


def test_jax_checkpoint_resumes_the_port(tmp_path):
    """A checkpoint the JAX FrameLoop writes resumes the port's loop to the
    same frame index, size and camera matrix (and the port's checkpoint
    resumes the JAX loop likewise)."""
    from swift3drenderer_tpu.app import FrameLoop as JaxLoop
    from swift3drenderer_tpu.app import scripted_inputs as jax_scripted
    from swift3drenderer_tpu.camera import Input as JaxInput
    from swift3drenderer_tpu.models import tetrahedron_scene as jax_tetra

    theirs = JaxLoop(jax_tetra(seed=0), 72, 40)
    for i, inp in enumerate(jax_scripted("5:w+mx3;4:d my-2", 9)):
        theirs.camera.update(inp, force_update=(i == 0))
    theirs.frame_index = 9
    path = str(tmp_path / "jax.json")
    theirs.save_checkpoint(path)
    ours = loop_of()
    ours.load_checkpoint(path)
    assert (ours.frame_index, ours.width, ours.height) == (9, 72, 40)
    np.testing.assert_array_equal(ours.camera.matrix, theirs.camera.matrix)
    np.testing.assert_array_equal(ours.camera.update(Input(up=1.0)),
                                  theirs.camera.update(JaxInput(up=1.0)))
    back = str(tmp_path / "port.json")
    ours.save_checkpoint(back)
    again = JaxLoop(jax_tetra(seed=0), 8, 8)
    again.load_checkpoint(back)
    np.testing.assert_array_equal(again.camera.matrix, ours.camera.matrix)


def test_telemetry_report():
    lines = []
    stats = FrameStats(report_interval=0.0, printer=lines.append)
    stats.add_frame(1.0 / 120.0, raster=0.001)
    assert stats.reports and abs(stats.reports[0]["percentage"] - 50.0) < 1e-6
    assert any("50.00%" in line for line in lines)
    assert any("raster=1.00ms" in line for line in lines)


def test_ansi_frame_matches_jax():
    from swift3drenderer_tpu.app import ansi_frame as jax_ansi

    px = np.full((8, 16), 0x112233, dtype=np.uint32)
    s = ansi_frame(px, columns=8)
    assert "\x1b[38;2;17;34;51m" in s and s.endswith("\x1b[0m")
    rng = np.random.default_rng(9)
    for shape, cols in (((48, 64), 100), ((37, 91), 40), ((5, 3), 10)):
        px = rng.integers(0, 1 << 24, size=shape).astype(np.uint32)
        assert ansi_frame(px, columns=cols) == jax_ansi(px, columns=cols)


def test_app_cli(tmp_path):
    out = str(tmp_path / "frames")
    rc = app_main(["--scene", "tetrahedron", "--width", "64", "--height", "48",
                   "--frames", "5", "--script", "5:w", "--out", out,
                   "--out-every", "2", "--device", "cpu"])
    assert rc == 0
    final = read_ppm(os.path.join(out, "final.ppm"))
    assert final.shape == (48, 64, 3)
    assert sorted(os.listdir(out)) == ["final.ppm", "frame_00001.ppm",
                                       "frame_00003.ppm", "frame_00005.ppm"]


def test_app_cli_on_a_data_bin_and_an_obj_with_the_xla_backend(tmp_path):
    data = str(tmp_path / "data.bin")
    assert datagen_main(["--scene", "tetrahedron", "--out", data]) == 0
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 4 3 2\n")
    ckpt = str(tmp_path / "ck.json")
    for scene in (data, str(obj)):
        rc = app_main(["--scene", scene, "--width", "32", "--height", "24",
                       "--frames", "3", "--device", "cpu", "--backend", "xla",
                       "--checkpoint", ckpt, "--out", str(tmp_path / "o")])
        assert rc == 0
    assert os.path.exists(ckpt)


@pytest.mark.parametrize("kind", ["scene", "atlas", "obj"])
def test_datagen_writes_the_jax_bytes(tmp_path, kind):
    """The port's datagen and the JAX one write the same files."""
    from swift3drenderer_tpu.datagen import main as jax_datagen

    if kind == "scene":
        args = ["--scene", "default", "--seed", "3"]
    elif kind == "atlas":
        base = np.random.default_rng(4).integers(0, 256, (256, 256, 3),
                                                 dtype=np.uint8)
        write_ppm(str(tmp_path / "base.ppm"), base)
        args = ["--atlas", str(tmp_path / "base.ppm")]
    else:
        (tmp_path / "m.obj").write_text(
            "o a\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nvn 0 0 1\n"
            "f 1//1 2//1 3//1\ng b\nf 1 3 4\nf -1 -2 -4\n")
        args = ["--obj", str(tmp_path / "m.obj"), "--scale", "2.5",
                "--offset", "0", "1", "-6"]
    assert datagen_main(args + ["--out", str(tmp_path / "port.out")]) == 0
    assert jax_datagen(args + ["--out", str(tmp_path / "jax.out")]) == 0
    ours = (tmp_path / "port.out").read_bytes()
    assert len(ours) > 500 and ours == (tmp_path / "jax.out").read_bytes()


def test_datagen_cli(tmp_path):
    out = str(tmp_path / "data.bin")
    assert datagen_main(["--scene", "default", "--seed", "none",
                         "--out", out]) == 0
    assert load_scene(out).num_triangles == 51


def boom(*a, **k):
    raise RuntimeError("device fault")


def test_no_fallback_raises(monkeypatch):
    """A render failure reaches the caller: the loop keeps its renderer and
    moves to no other backend."""
    loop = loop_of()
    renderer = loop.renderer
    monkeypatch.setattr(loop.renderer, "render", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        loop.step()
    assert loop.renderer is renderer and renderer.backend == "cuda"
    assert loop.frame_index == 0
