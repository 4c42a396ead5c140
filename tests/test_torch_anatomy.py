"""The port's stage probes, ``tools.perf_probe`` and ``tools.stress_probe``
(counterparts of the repo's ``tools/perf_probe.py`` and
``tools/stress_probe.py``), on the CPU at tiny sizes: every stage present
and timed, each stage's outputs what it stands for (the full stage is the
renderer's frame, the grid stage the background, the front-end every input
of the launch), and the tools' flags and line formats those of the JAX
tools. The times here are the CPU's; the card's come from chip_smoke.py.
"""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

from swift3drenderer_tpu_torch import DEFAULT_CONFIG, Renderer
from swift3drenderer_tpu_torch.models import SCENES, stress_scene
from swift3drenderer_tpu_torch.ops import raster
from swift3drenderer_tpu_torch.renderer import build_setup
from swift3drenderer_tpu_torch.tools import perf_probe, stress_probe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BG = DEFAULT_CONFIG.background_packed
W, H = 96, 64


def _jax_tool(name):
    """A JAX tool's module, loaded from its file (it imports JAX only inside
    its functions)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(path):
    """Each ``add_argument("--flag", ...)`` of a tool's source: {flag:
    default}."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = ast.literal_eval(node.args[0])
            kw = {k.arg: k.value for k in node.keywords}
            out[flag] = (ast.literal_eval(kw["default"]) if "default" in kw
                         else None)
    return out


@pytest.mark.parametrize("tool", ["perf_probe", "stress_probe"])
def test_flags_match_the_jax_tools(tool):
    """The port's flags are the JAX tool's with their defaults, less the
    TPU kernel's --tile-h, plus --device."""
    theirs = _flags(os.path.join(REPO, "tools", f"{tool}.py"))
    ours = _flags(os.path.join(REPO, "swift3drenderer_tpu_torch", "tools",
                               f"{tool}.py"))
    theirs.pop("--tile-h", None)
    assert ours.pop("--device") == "cuda"
    assert ours == theirs


def test_perf_probe_line_matches_the_jax_tool(monkeypatch, capsys):
    """Given the same stage times, main prints the JAX tool's line (without
    its tile_h), after a line naming the device."""
    r = {"frontend": 1.25, "grid": 0.5, "vis": 2.0, "shade": 3.125,
         "full": 4.0}
    jax_tool = _jax_tool("perf_probe")
    monkeypatch.setattr(jax_tool, "setup_cache", lambda: None)
    monkeypatch.setattr(jax_tool, "probe", lambda *a, **k: r)
    monkeypatch.setattr("sys.argv", ["perf_probe", "--configs", "96x64"])
    jax_tool.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(perf_probe, "probe", lambda *a, **k: r)
    assert perf_probe.main(["--configs", "96x64", "--device", "cpu"]) == {
        "96x64": r}
    ours = capsys.readouterr().out.strip().splitlines()
    assert ours[0].startswith("device: cpu")
    assert ours[1:] == [line.replace(" tile_h=64", "") for line in theirs]


def test_perf_probe_stages_on_the_cpu():
    """probe gives every stage of the tool, each >= 0."""
    ms = perf_probe.probe("default", W, H, frames=2, device="cpu")
    assert tuple(ms) == perf_probe.PROBE_STAGES
    assert all(v >= 0 for v in ms.values())


def test_stress_probe_on_the_cpu(capsys):
    """stress_probe's stages (prelive, vis, shade, full), each >= 0, on the
    segmented route; main prints the JAX tool's lines."""
    ms = stress_probe.probe("stress", 8, W, H, frames=2, device="cpu")
    assert tuple(ms) == ("prelive", "vis", "shade", "full")
    assert all(v >= 0 for v in ms.values())
    tris = stress_scene(seed=0, objects=8).num_triangles
    assert 2 * tris > raster.FLAT_MAX_SLOTS
    assert stress_probe.main(["--objects", "8", "--w", str(W), "--h", str(H),
                              "--frames", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1] == f"{tris} tris, {W}x{H}"
    names = [line.split()[0] for line in lines[2:]]
    assert names == ["prelive", "vis", "shade", "full"]
    assert all(line.endswith(" ms")
               and len(line.split()[1].split(".")[1]) == 3
               for line in lines[2:])
    src = open(os.path.join(REPO, "tools", "stress_probe.py")).read()
    assert 'f"{name:8s} {ms:7.3f} ms"' in src


@pytest.mark.parametrize("name", ["default", "stress"])
def test_stage_outputs(name):
    """The full stage is Renderer.render's frame; grid is the background
    with nothing drawn; vis and shade are rasterize's forms; frontend is
    every input of the route's launch."""
    scene = (SCENES["default"](seed=0) if name == "default"
             else stress_scene(seed=0, objects=8))
    stages = perf_probe.Stages(scene, W, H, device="cpu")
    m = perf_probe.flight(3)[2]
    pix, depth = stages.run("full", m)
    want, want_depth = Renderer(scene, device="cpu").render(m, W, H)
    np.testing.assert_array_equal(pix.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(depth.numpy(), want_depth)
    assert (depth > 0).any()
    grid_pix, grid_depth = stages.run("grid", m)
    assert bool((grid_pix == BG).all()) and bool((grid_depth == 0).all())
    vis_pix, vis_depth = stages.run("vis", m)
    assert torch.equal(vis_depth, depth)
    assert bool(((vis_pix >= 0) == (depth > 0)).all())
    shade_pix, _ = stages.run("shade", m)
    flat = (shade_pix != BG) | (pix == BG)
    assert torch.equal(shade_pix[flat], pix[flat])
    front = stages.run("frontend", m)
    assert len(front) == (4 if name == "default" else 9)
    setup = build_setup(stages.dev, torch.from_numpy(m), width=W, height=H,
                        config=DEFAULT_CONFIG)
    assert all(torch.equal(a, b) for a, b in zip(stages.run("setup", m),
                                                 setup.values()))
