"""Vertex and normal stages — ``(N, 4) @ (4, 3)`` products plus an elementwise
projection (counterpart of ``swift3drenderer_tpu.ops.vertex``).

The JAX package runs these products at ``Precision.HIGHEST`` because reduced
precision visibly moves the barycentric weights. The port's products are full
fp32, written as four multiplies and three adds in a fixed order rather than
``torch.matmul``: cuBLAS and the CPU's BLAS are free to order and fuse the four
products differently, and one ULP in a vertex can move an edge pixel's winner.
Written out, every device rounds them alike, so the CPU tests check the very
setup table the card computes. TF32 is switched off for
matmuls and cuDNN when this module is imported, so no product of the port
depends on what a caller left enabled.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _times_mt(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m.T`` for x (N, 4) and m (..., 3, 4), summed left to right:
    (..., N, 3), each frame of a batch of matrices rounded as alone."""
    m = m[..., None, :, :]
    return (x[:, 0:1] * m[..., 0] + x[:, 1:2] * m[..., 1]
            + x[:, 2:3] * m[..., 2] + x[:, 3:4] * m[..., 3])


def transform_points(vertices: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Camera-space positions: ``cv = M . v`` (render.swift:249).

    vertices: (V, 4) with w == 1; m: (3, 4) row-major view matrix, or a
    (B, 3, 4) batch of them (then (B, V, 3)).
    """
    return _times_mt(vertices, m)


def project(cv: torch.Tensor, factor, half_w, half_h) -> torch.Tensor:
    """Raster vertices (render.swift:251): screen xy from the pinhole
    ``(x, -y) * factor / -z`` plus screen center; rv.z holds the view depth -z.

    The constants are Python floats (the exact-size frame) or 0-dim float32
    tensors on ``cv``'s device (the bucketed frame). A float operand is
    rounded to float32 once, so the host must round ``factor`` from its
    float64 value for both to agree bit for bit (``renderer.frame_dims``)."""
    z = -cv[..., 2]
    sx = cv[..., 0] * factor / z + half_w
    sy = -cv[..., 1] * factor / z + half_h
    return torch.stack([sx, sy, z], dim=-1)


def transform_normals(normals: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Camera-space normals ``n = M . normal`` with w == 0 so translation drops
    out (render.swift:254)."""
    return _times_mt(normals, m)
