"""The port's validation matrix (``swift3drenderer_tpu_torch.tools.validate``)
on the CPU, against the TPU tool it mirrors (``tools/tpu_validate.py``):
a row for every case the tool prints, the tool's fuzz draws bit for bit
(restated with the JAX package's Camera, Input and SCENES), the tool's
128-texture scene array for array, the tool's mismatch, and the matrix
itself through the kernels' plain versions."""

import ast
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from swift3drenderer_tpu_torch.tools import validate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "tpu_validate.py")
FUZZ_DRAWS = 12


def tool_labels():
    """Every case label tools/tpu_validate.py prints, read from its source:
    the ``cases`` list, the multipass loop's labels and each
    ``{'...':22s}`` field."""
    with open(TOOL) as f:
        tree = ast.parse(f.read())
    labels = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "cases"
                for t in node.targets):
            labels += [e.elts[0].value for e in node.value.elts]
        elif (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
              and isinstance(node.target.elts[0], ast.Name)
              and node.target.elts[0].id == "label"):
            labels += [e.elts[0].value for e in node.iter.elts]
        elif (isinstance(node, ast.FormattedValue)
              and isinstance(node.value, ast.Constant)
              and isinstance(node.format_spec, ast.JoinedStr)
              and [v.value for v in node.format_spec.values] == ["22s"]):
            labels.append(node.value.value)
    return labels


def load_tool():
    spec = importlib.util.spec_from_file_location("tpu_validate", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_case_table_has_a_row_for_every_tpu_case():
    """Each label the TPU tool prints has exactly one row, and each row a
    route, a sampling with a golden bound and something to hold it to."""
    labels = tool_labels()
    assert len(labels) == len(set(labels)) == 22
    with open(TOOL) as f:
        source = f.readlines()
    names = [c.name for c in validate.CASES]
    assert sorted(names) == sorted(labels)
    for case in validate.CASES:
        assert case.route in validate.ROUTES, case
        assert case.sampling in validate.GOLDEN_BOUND, case
        assert case.golden or case.equal, case
        validate.Context(torch.device("cpu")).pose(case.pose)
        # The row names the TPU case's lines: the first range holds its label.
        lo, _, hi = case.replaces.split(",")[0].strip(" :").partition("-")
        assert case.name in "".join(source[int(lo) - 1:int(hi or lo)]), case
    # Where the TPU tool compared two device paths, the port holds them
    # bit-equal.
    for name in ("bucketed-resize", "batch-B4-vs-single",
                 "corners-ids-vs-seq10k", "tri-sharded-n1-10k"):
        assert next(c for c in validate.CASES if c.name == name).equal
    assert [c.name for c in validate.CASES if c.big] == ["stress100k-compact"]


@pytest.mark.parametrize("k", range(FUZZ_DRAWS))
def test_fuzz_case_is_the_tpu_tools_draw(k):
    """Port case k is the TPU tool's draw k: the tool's loop
    (tools/tpu_validate.py:415-431) restated with the JAX package."""
    from swift3drenderer_tpu.camera import Camera, Input
    from swift3drenderer_tpu.models import SCENES

    rng = np.random.default_rng(7000 + k)
    name = list(SCENES)[int(rng.integers(0, len(SCENES)))]
    seed = int(rng.integers(0, 100))
    sampling = "bilinear" if rng.integers(0, 4) == 0 else "nearest"
    cam = Camera()
    m = cam.update(Input(), force_update=True)
    for _ in range(int(rng.integers(1, 6))):
        m = cam.update(Input(
            up=float(rng.uniform(0, 2)), down=float(rng.uniform(0, 1)),
            left=float(rng.uniform(0, 1)), right=float(rng.uniform(0, 1)),
            mouse=(float(rng.uniform(-120, 120)),
                   float(rng.uniform(-80, 80)))))
    w = int(rng.integers(20, 60)) * 8
    h = int(rng.integers(12, 40)) * 8

    d = validate.fuzz_draw(k)
    assert (d.family, d.seed, d.sampling, d.width, d.height) == (
        name, seed, sampling, w, h)
    assert d.matrix.dtype == np.float32
    np.testing.assert_array_equal(d.matrix, np.asarray(m, np.float32))
    case = validate.fuzz_case(k)
    assert (case.name, case.scene, case.size, case.sampling) == (
        f"fuzz[{k}]", f"{name}:{seed}", (w, h), sampling)


def test_paged_scene_is_the_tpu_tools_scene():
    """The 128-texture scene, built as tools/tpu_validate.py:219-230 builds
    it with the JAX package's modules, equals the port's array for array."""
    import swift3drenderer_tpu.models.scene as scene_mod
    from swift3drenderer_tpu.models.textures import default_texture_words

    big_tex = np.concatenate([default_texture_words(2)] * 64)
    paged = scene_mod.stress_scene(seed=0, objects=24, textures=big_tex)
    tex = paged.attr_tex.copy()
    tri_tex = paged.attribute_indices.reshape(-1, 3)
    for t, corners in enumerate(tri_tex):
        for a in corners:
            if tex[a] >= 0:
                tex[a] = t % 128
    paged.attr_tex = tex
    paged.validate()

    ours = validate.paged_scene()
    assert ours.textures.shape == (128, 512, 512)
    for field in dataclasses.fields(paged):
        a, b = getattr(ours, field.name), getattr(paged, field.name)
        assert a.dtype == b.dtype and a.shape == b.shape, field.name
        np.testing.assert_array_equal(a, b, err_msg=field.name)


def test_mismatch_is_the_tpu_tools():
    """The port's copy of ``mismatch`` gives the tool's reading on the same
    packed frames, at several tolerances."""
    tool = load_tool()
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 24, size=(48, 64), dtype=np.uint32)
    b = a.copy()
    flip = rng.random(a.shape) < 0.2
    b[flip] ^= rng.integers(0, 8, size=int(flip.sum()), dtype=np.uint32) << (
        8 * rng.integers(0, 3, size=int(flip.sum())).astype(np.uint32))
    for tol in (0, 1, 2, 4):
        assert validate.mismatch(a, b, tol) == tool.mismatch(a, b, tol)
    assert validate.mismatch(a, a) == tool.mismatch(a, a) == 0.0


def test_matrix_passes_on_cpu(monkeypatch, capsys):
    """The whole matrix but the 100k row, and the first three fuzz draws,
    through the plain versions: every line PASS, main returns 0, and each
    mismatch it reads equals the tool's on the same arrays."""
    tool, ours, agree = load_tool(), validate.mismatch, []

    def both(a, b, tol=1):
        frac = ours(a, b, tol)
        agree.append(frac == tool.mismatch(a, b, tol))
        return frac
    monkeypatch.setattr(validate, "mismatch", both)
    assert validate.main(["--device", "cpu", "--no-100k", "--fuzz", "3"]) == 0
    assert len(agree) >= 21 + 3 and all(agree)
    lines = capsys.readouterr().out.splitlines()
    results = [line for line in lines if line.startswith(("PASS", "FAIL"))]
    assert len(results) == 21 + 3
    assert all(line.startswith("PASS") for line in results), results
    for case in validate.CASES:
        if not case.big:
            assert any(line.split()[1] == case.name for line in results)
    assert lines[-1] == "ALL PASS"


def test_failing_case_makes_main_return_1(monkeypatch, capsys):
    """A case over its bound is a FAIL line, and main returns 1; a path
    that raises ends the run with its exception."""
    case = next(c for c in validate.CASES if c.name == "tetrahedron")
    monkeypatch.setattr(validate, "CASES", (case,))
    monkeypatch.setattr(validate, "GOLDEN_BOUND",
                        {"nearest": 0.0, "bilinear": 0.0})
    assert validate.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("FAIL  tetrahedron") and out[-1] == "1 FAILURES"

    def broken(ctx, case, device):
        raise RuntimeError("broken path")
    monkeypatch.setitem(validate.ROUTES, "render", broken)
    with pytest.raises(RuntimeError, match="broken path"):
        validate.main(["--device", "cpu"])
