"""device.idle_share.frame: see s3dbench/readers.py::idle_share."""

from s3dbench.readers import idle_share as read  # noqa: F401
