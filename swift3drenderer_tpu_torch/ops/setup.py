"""Per-triangle raster setup (counterpart of ``swift3drenderer_tpu.ops.setup``):
all per-triangle constants of the reference's triangle loop
(render/render.swift:274-318) computed as one dense batch.

The output is a structure-of-arrays "setup table" over S = 2T slots (post-clip);
culled/invalid slots stay in the table with ``live == False`` so every downstream
shape is static.
"""

from __future__ import annotations

from typing import Dict

import torch

Setup = Dict[str, torch.Tensor]

_I32_MAX = 2147483647


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 toward zero, saturating, NaN -> 0.

    XLA's conversion and CUDA's ``cvt.rzi.s32.f32`` both behave so; a bare
    ``.to(torch.int32)`` on the CPU leaves NaN and out-of-range values
    undefined (INT_MIN on x86)."""
    y = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(x >= 2147483648.0, _I32_MAX, y.to(torch.int32))


def edge_function(ax, ay, bx, by, cx, cy):
    """Signed parallelogram area (render.swift:89-92), coordinate-wise form."""
    return (cx - ax) * (ay - by) + (cy - ay) * (bx - ax)


def triangle_setup(corners: Dict[str, torch.Tensor], width, height,
                   min_area: float) -> Setup:
    # width/height are Python ints (the exact-size frame) or 0-dim float32
    # tensors on the corners' device (the bucketed frame: the raster extent
    # is the bucket's, the true size only bounds coverage); both are exact
    # in float32, so the two give the same table bit for bit.
    rv = corners["rv"]                       # (S, 3, 3)
    cv = corners["cv"]
    attr = corners["attr"]
    n = corners["n"]
    valid = corners["valid"]

    rvmax = rv.amax(dim=1)                   # (S, 3)
    rvmin = rv.amin(dim=1)
    # Screen-bounds reject (render.swift:274-277) and small/backface area cull
    # (render.swift:279-280).
    area = edge_function(rv[:, 0, 0], rv[:, 0, 1], rv[:, 1, 0], rv[:, 1, 1],
                         rv[:, 2, 0], rv[:, 2, 1])
    live = (
        valid
        & (rvmax[:, 0] >= 0) & (rvmax[:, 1] >= 0)
        & (rvmin[:, 0] < width) & (rvmin[:, 1] < height)
        & (area >= min_area)
    )
    ooa = torch.where(area != 0, 1.0 / area, 0.0)

    # Closed-form barycentric setup at the global pixel-(0, 0) center:
    # w(px, py) = w00 + px * dx + py * dy (replaces the incremental edge walk,
    # render.swift:286-291, 334-339). The +0.5 pixel center lives here.
    p = 0.5
    w00 = torch.stack(
        [edge_function(rv[:, 1, 0], rv[:, 1, 1], rv[:, 2, 0], rv[:, 2, 1], p, p),
         edge_function(rv[:, 2, 0], rv[:, 2, 1], rv[:, 0, 0], rv[:, 0, 1], p, p),
         edge_function(rv[:, 0, 0], rv[:, 0, 1], rv[:, 1, 0], rv[:, 1, 1], p, p)],
        dim=1) * ooa[:, None]
    dx = torch.stack(
        [rv[:, 1, 1] - rv[:, 2, 1],
         rv[:, 2, 1] - rv[:, 0, 1],
         rv[:, 0, 1] - rv[:, 1, 1]], dim=1) * ooa[:, None]
    dy = torch.stack(
        [rv[:, 2, 0] - rv[:, 1, 0],
         rv[:, 0, 0] - rv[:, 2, 0],
         rv[:, 1, 0] - rv[:, 0, 0]], dim=1) * ooa[:, None]

    # Integer bbox, truncation semantics matching Swift Int() (render.swift:282-285).
    xmin = trunc_i32(torch.clamp(rvmin[:, 0], min=0.0))
    xmax = trunc_i32(torch.clamp(rvmax[:, 0], max=width - 1))
    ymin = trunc_i32(torch.clamp(rvmin[:, 1], min=0.0))
    ymax = trunc_i32(torch.clamp(rvmax[:, 1], max=height - 1))

    # Perspective premultiply (render.swift:297-299).
    rvz = 1.0 / rv[:, :, 2]                  # (S, 3)
    cvp = cv * rvz[..., None]
    np_ = n * rvz[..., None]
    attrp = attr * rvz[..., None]

    # Texture constants (render.swift:305-311): dz = (rvz.dx, rvz.dy);
    # tpp = (sum u'_i dx_i, sum v'_i dy_i). The three-term sums are written
    # out so their order is fixed on every device.
    def sum3(a):
        return a[:, 0] + a[:, 1] + a[:, 2]

    dzv = torch.stack([sum3(rvz * dx), sum3(rvz * dy)], dim=1)
    tpp = torch.stack([sum3(attrp[:, :, 0] * dx), sum3(attrp[:, :, 1] * dy)],
                      dim=1)

    return dict(
        live=live,
        w00=w00, dx=dx, dy=dy, rvz=rvz,
        cvp=cvp, np=np_, attrp=attrp,
        tex=corners["tex"].to(torch.int32),
        is_tex=corners["tex"] >= 0,
        tpp=tpp, dzv=dzv,
        xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
    )
