"""The golden numpy oracle (copy of ``swift3drenderer_tpu.golden``)."""

from .renderer import render_frame  # noqa: F401
