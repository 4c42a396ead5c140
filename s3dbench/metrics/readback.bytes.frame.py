"""readback.bytes.frame: see s3dbench/readers.py::readback_bytes."""

from s3dbench.readers import readback_bytes as read  # noqa: F401
