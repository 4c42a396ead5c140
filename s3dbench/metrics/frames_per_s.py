"""frames_per_s: see s3dbench/readers.py::frames_per_s."""

from s3dbench.readers import frames_per_s as read  # noqa: F401
