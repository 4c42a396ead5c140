"""``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names its configuration and its traffic mix;
the harness finds each by name:

- the configuration's file is the ``file`` of its ``configs`` entry
  (``configs/<config>.json``);
- the traffic mix is ``traffic/<traffic>.json``;
- the cell's correctness limits are ``checks/<workload>.json``;
- every metric, end-to-end or per-layer, is read by ``metrics/<name>.py``.

A cell held back from ``BENCHMARK.json`` is ``held/<workload>.json``: its
``workloads`` entry (``workload``) and every metric entry it reports
(``end_to_end``, ``per_layer``), in ``BENCHMARK.json``'s form without
``workloads`` keys, and why it is held (``held``). It runs by name like a
listed cell, and its
configuration is a ``configs`` entry of ``BENCHMARK.json``; only a listed
cell is ever checked against a bound.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os
import re
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def benchmark() -> dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) in reported if "moves" in metric else True


def held() -> List[str]:
    """The names of the cells held back from ``BENCHMARK.json``."""
    return sorted(os.path.basename(p)[:-len(".json")]
                  for p in glob.glob(os.path.join(HERE, "held", "*.json")))


def cell(name: str) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json``, or the held cell
    ``name``, resolved."""
    spec = benchmark()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if found:
        w = found[0]
        e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
        reported = {m["name"] for m in e2e}
        layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    elif name in held():
        entry = _load(os.path.join(HERE, "held", name + ".json"))
        w, e2e, layer = (entry["workload"], entry["end_to_end"],
                         entry["per_layer"])
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or held/")
    config = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]),
                config=_load(os.path.join(ROOT, config["file"])),
                traffic=_load(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json")),
                check=_load(os.path.join(HERE, "checks", name + ".json")),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "s3dbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
