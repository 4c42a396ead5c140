"""frontend.device_us.frame: see s3dbench/readers.py::frontend_device_us."""

from s3dbench.readers import frontend_device_us as read  # noqa: F401
