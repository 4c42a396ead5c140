"""setup_s: see s3dbench/readers.py::setup_s."""

from s3dbench.readers import setup_s as read  # noqa: F401
