"""kernel.roofline.batch: see s3dbench/readers.py::kernel_roofline."""

from s3dbench.readers import kernel_roofline as read  # noqa: F401
