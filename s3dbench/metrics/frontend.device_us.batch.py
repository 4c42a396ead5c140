"""frontend.device_us.batch: see s3dbench/readers.py::frontend_device_us."""

from s3dbench.readers import frontend_device_us as read  # noqa: F401
