"""Plugins for every pytest run of this repo, beside tests/conftest.py:
tests/_time_limit.py (a time limit for every test) and tests/_reference_suite.py
(how a run treats the test files from before the port)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

pytest_plugins = ["_time_limit", "_reference_suite"]
