"""tests/_reference_suite.py: its work units name every test of their files
once; and under ``-n 2 --dist loadfile`` each unit runs whole on
one worker, in the order of its names, and the units are handed out first, in
their order.

The second test runs a pytest session in a subprocess on stand-ins of those
files (tests that pass at once, under the real tests' names), with the
plugin loaded by ``-p`` and nothing of this repo's conftest.py. About 5 s on
one process."""

import ast
import os
import re
import subprocess
import sys
from collections import Counter

import _reference_suite as suite

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _test_functions(path):
    tree = ast.parse(open(os.path.join(_REPO, path)).read())
    return [node.name for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and node.name.startswith("test_")]


def test_units_name_each_test_of_their_files_once():
    listed = Counter((path, name) for path, names in suite.UNITS
                     for name in names)
    assert max(listed.values()) == 1
    for path in {path for path, _ in suite.UNITS}:
        assert sorted(_test_functions(path)) == sorted(
            name for p, name in listed if p == path), path
    for nodeid in suite.TIME_LIMITS:
        path, name = nodeid.split("::")
        assert name in _test_functions(path), nodeid


def test_units_run_whole_in_order_and_first(tmp_path):
    # Stand-ins: each listed name, and two tests of an unlisted file.
    files = {}
    for path, names in suite.UNITS:
        files.setdefault(path, []).extend(names)
    files["tests/test_other.py"] = ["test_other_a", "test_other_b"]
    for path, names in files.items():
        target = tmp_path / path
        target.parent.mkdir(exist_ok=True)
        # Reversed, so that a unit's order cannot come from the file's.
        target.write_text("".join(f"def {name}():\n    pass\n\n\n"
                                  for name in reversed(names)))
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    # The session loads only the plugins its command line names.
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_PLUGINS", "PYTEST_ADDOPTS")}
    env["PYTHONPATH"] = os.path.join(_REPO, "tests")
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-p", "_reference_suite",
         "-n", "2", "--dist", "loadfile", "tests"],
        cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    ran = {}  # worker -> node ids in the order it ran them
    for worker, nodeid in re.findall(
            r"^\[(gw\d)\] \[ *\d+%\] PASSED (\S+) *$", run.stdout, re.M):
        ran.setdefault(worker, []).append(nodeid)
    assert sum(map(len, ran.values())) == sum(map(len, files.values()))
    # Each worker runs whole units, each in the order of its names, and takes
    # them from the front of one queue: the listed units in their order, then
    # the other file.
    rank = {f"{path}::{name}": i for i, (path, names) in enumerate(suite.UNITS)
            for name in names}
    first = {f"{path}::{names[0]}": (path, names)
             for path, names in suite.UNITS}
    seen = 0
    for nodeids in ran.values():
        ranks = [rank.get(nodeid, len(suite.UNITS)) for nodeid in nodeids]
        assert ranks == sorted(ranks), nodeids
        for at, nodeid in enumerate(nodeids):
            if nodeid in first:
                path, names = first[nodeid]
                assert nodeids[at:at + len(names)] == [
                    f"{path}::{name}" for name in names], nodeids
                seen += 1
    assert seen == len(suite.UNITS)
    # The two workers take the first two units at once.
    assert sorted(nodeids[0] for nodeids in ran.values()) == sorted(
        list(first)[:2])
