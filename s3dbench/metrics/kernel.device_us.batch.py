"""kernel.device_us.batch: see s3dbench/readers.py::kernel_device_us."""

from s3dbench.readers import kernel_device_us as read  # noqa: F401
