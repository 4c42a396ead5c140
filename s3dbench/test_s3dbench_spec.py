"""BENCHMARK.json against the files it names, the contract's character
rules, and what the benchmark's modules may import.

Run from the repository root: ``python -m pytest s3dbench -q``.
"""

import ast
import glob
import os
import re

import pytest

from s3dbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MODULES = sorted(glob.glob(os.path.join(spec.HERE, "**", "*.py"),
                           recursive=True))
# The yardstick: what generates the work, the reference and the arithmetic
# of the metrics. None of it may import the program under test.
YARDSTICK = ("scenegen.py", "flight.py", "reference.py", "roofline.py",
             "tracing.py", "readers.py", "spec.py", "clocks.py")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _held(name):
    return spec._load(os.path.join(spec.HERE, "held", name + ".json"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]]
                         + spec.held())
def test_workload_resolves_by_name(workload):
    cell = spec.cell(workload)
    entry = ([w for w in BENCH["workloads"] if w["name"] == workload]
             or [_held(workload)["workload"]])[0]
    assert cell.config_name == entry["config"]
    assert cell.traffic_name == entry["traffic"]
    assert cell.config["name"] == entry["config"]
    assert cell.chips == 1
    assert 0 < cell.check["mismatch_max"] < 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_names_and_units_use_allowed_characters():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            for field in ("name", "config", "traffic"):
                if field in entry:
                    assert NAME.match(entry[field]), entry[field]
            for reduced in entry.get("reduced", []):
                assert NAME.match(reduced), reduced
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for path in glob.glob(os.path.join(spec.HERE, "**", "*"), recursive=True):
        rel = os.path.relpath(path, spec.ROOT)
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_entries_have_the_contract_keys_and_lengths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("s3dbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]
    every = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(every) == len(set(every))
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {os.path.basename(p)[:-3]
             for p in glob.glob(os.path.join(spec.HERE, "metrics", "*.py"))}
    names = {m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]}
    names |= {m["name"] for w in spec.held() for k in ("end_to_end", "per_layer")
              for m in _held(w)[k]}
    assert files == names


@pytest.mark.parametrize("workload", spec.held())
def test_a_held_cell_is_in_the_form_benchmark_json_takes(workload):
    held = _held(workload)
    assert set(held) == {"held", "workload", "end_to_end", "per_layer"}
    assert 1 <= len(held["held"]) <= 200
    assert workload not in [w["name"] for w in BENCH["workloads"]]
    w = held["workload"]
    assert w["name"] == workload
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["config"] in [c["name"] for c in BENCH["configs"]]
    assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    listed = {m["name"]: m for k in ("end_to_end", "per_layer")
              for m in BENCH[k]}
    for key, fields in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for m in held[key]:
            assert set(m) == fields and NAME.match(m["name"])
            assert UNIT.match(m["unit"])
            if m["name"] in listed:     # a listed metric, as it is listed
                same = {k: v for k, v in listed[m["name"]].items()
                        if k != "workloads"}
                assert m == same


@pytest.mark.parametrize("path", MODULES, ids=os.path.basename)
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "swift3drenderer_tpu"), name
        assert top not in ("bench", "chip_smoke", "tools"), name
        assert not name.startswith("swift3drenderer_tpu_torch.tools"), name


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    for imported in _imports(os.path.join(spec.HERE, name)):
        assert not imported.startswith("swift3drenderer_tpu"), imported
