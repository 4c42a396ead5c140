"""entry.host_us.batch: see s3dbench/readers.py::entry_host_us."""

from s3dbench.readers import entry_host_us as read  # noqa: F401
