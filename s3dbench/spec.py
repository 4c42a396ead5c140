"""``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names its configuration and its traffic mix;
the harness finds each by name:

- the configuration's file is the ``file`` of its ``configs`` entry
  (``configs/<config>.json``);
- the traffic mix is ``traffic/<traffic>.json``;
- the cell's correctness limits are ``checks/<workload>.json``;
- every metric, end-to-end or per-layer, is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
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


def cell(name: str) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json``, resolved."""
    spec = benchmark()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
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
