"""frame_ms: see s3dbench/readers.py::frame_ms."""

from s3dbench.readers import frame_ms as read  # noqa: F401
