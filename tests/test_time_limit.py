"""The per-test time limit of tests/_time_limit.py: a test past its limit fails
with the limit's message within seconds, and a test under it passes.

Runs a small pytest session in a subprocess on a temp file, with the plugin
loaded by ``-p`` and nothing of this repo's conftest.py (no JAX, no build).
About 3 s on one process."""

import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

_TESTS = os.path.dirname(os.path.abspath(__file__))

_SESSION = '''
import time

import pytest


@pytest.mark.time_limit(2)
def test_sleeps_past_its_limit():
    time.sleep(60)


@pytest.mark.time_limit(2)
def test_stays_under_its_limit():
    time.sleep(0.1)
'''


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.mktemp("time_limit")
    (root / "pytest.ini").write_text(
        "[pytest]\nmarkers =\n    time_limit(seconds): the test's limit\n")
    (root / "test_session.py").write_text(_SESSION)
    # The session loads only the plugin its command line names.
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_PLUGINS", "PYTEST_ADDOPTS")}
    env.update(PYTHONPATH=_TESTS, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    start = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "_time_limit", "--junitxml", str(root / "out.xml"),
         "test_session.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - start
    cases = {case.get("name"): case
             for case in ET.parse(root / "out.xml").iter("testcase")}
    return run, seconds, cases


def test_a_test_past_its_limit_fails(session):
    run, seconds, cases = session
    assert run.returncode == 1, run.stdout + run.stderr
    failure = cases["test_sleeps_past_its_limit"].find("failure")
    assert failure is not None
    assert ("test_session.py::test_sleeps_past_its_limit ran past its time "
            "limit of 2 s (in call)") in failure.get("message")
    # Cut at its 2 s limit, not after its 60 s sleep.
    assert seconds < 30, seconds


def test_a_test_under_its_limit_passes(session):
    run, _, cases = session
    case = cases["test_stays_under_its_limit"]
    assert list(case) == [], ET.tostring(case)
