"""A time limit for every test, so that a test that hangs costs one test and not
the suite.

Each phase of a test (setup, call, teardown) runs under the test's limit:
``DEFAULT_SECONDS``, or the seconds of its ``time_limit`` marker. When the limit
passes, SIGALRM fails the test where it stands (``pytest.fail``, which pytest
handles in every phase) with a message naming the test and its limit. A signal
cannot break a wait inside C code (an XLA compile, a socket read), so each
phase also arms faulthandler to print every thread's stack to the session's
stderr ``STACK_DUMP_GRACE`` seconds after the limit.

Loaded by the repo's root conftest.py (``pytest_plugins``), or on its own with
``-p _time_limit`` when tests/ is on ``sys.path``. Runs on the main thread of
each process, as pytest and pytest-xdist's workers run tests on Linux.
"""

import contextlib
import faulthandler
import os
import signal
import sys

import pytest

DEFAULT_SECONDS = 600.0
STACK_DUMP_GRACE = 30.0

_stderr_fd = pytest.StashKey[int]()


def pytest_configure(config):
    # A copy of the real stderr, taken while output capture is suspended, so
    # that a stack dump reaches the log even while the test's output is captured.
    config.stash[_stderr_fd] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])


@contextlib.contextmanager
def _limited(item, phase):
    marker = item.get_closest_marker("time_limit")
    seconds = float(marker.args[0]) if marker else DEFAULT_SECONDS

    def expire(signum, frame):
        pytest.fail(
            f"{item.nodeid} ran past its time limit of {seconds:g} s "
            f"(in {phase})")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(
        seconds + STACK_DUMP_GRACE, exit=False,
        file=item.config.stash[_stderr_fd])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _limited(item, "teardown"):
        return (yield)
