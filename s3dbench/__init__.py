"""s3dbench: the benchmark of ``swift3drenderer_tpu_torch`` (README.md)."""
