"""frontend.kernels.batch: see s3dbench/readers.py::frontend_kernels."""

from s3dbench.readers import frontend_kernels as read  # noqa: F401
