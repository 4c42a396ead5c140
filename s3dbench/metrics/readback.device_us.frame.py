"""readback.device_us.frame: see s3dbench/readers.py::readback_device_us."""

from s3dbench.readers import readback_device_us as read  # noqa: F401
