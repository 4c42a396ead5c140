"""Near-plane clip prepass (counterpart of ``swift3drenderer_tpu.ops.clip``).

The reference clips lazily inside its triangle loop and appends split triangles
to the scene arrays (render/render.swift:177-227). Every triangle emits at most
two, so the prepass maps T input triangles to exactly 2T output slots with a
validity mask:

  slot 2t   — the "primary": the original triangle, shrunk in place (one corner in
              front) or with one corner replaced by a crossing point (two in front)
  slot 2t+1 — the "appended" split triangle; valid only in the two-in-front case

Crossing points are lerped at ``a = (near - z_i) / (z_next - z_i)`` and their raster
vertex recomputed at depth == near (render.swift:187-189). The corner choices are
masked selects, as in the JAX module, so both compute the same values.
"""

from __future__ import annotations

from typing import Dict

import torch

Corners = Dict[str, torch.Tensor]


def _rot1(x: torch.Tensor) -> torch.Tensor:
    """``x[:, [1, 2, 0]]``."""
    return torch.cat([x[:, 1:], x[:, :1]], dim=1)


def _gather3(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[t, idx[t, c], :]`` for idx in [0, 3) as masked selects."""
    out = torch.zeros_like(arr)
    for k in range(3):
        out = torch.where((idx == k)[..., None], arr[:, k][:, None, :], out)
    return out


def clip_prepass(
    cv: torch.Tensor,    # (T, 3, 3) camera-space corner positions
    rv: torch.Tensor,    # (T, 3, 3) raster corners (screen x, y, view depth)
    attr: torch.Tensor,  # (T, 3, 3) RGB or (u, v, 0)
    n: torch.Tensor,     # (T, 3, 3) camera-space corner normals
    tex: torch.Tensor,   # (T,) texture index or -1
    near: float,
    factor,
    half_w,
    half_h,
) -> Corners:
    """Returns corner arrays with leading dim 2T plus a ``valid`` mask (2T,).
    ``factor``, ``half_w`` and ``half_h`` are Python floats or 0-dim float32
    tensors on the corners' device (``ops.vertex.project``). Every tensor is
    made on the device, none copied from the host, so the prepass can be
    captured in a CUDA graph."""
    t = cv.shape[0]
    z = rv[..., 2]                       # (T, 3) view depths
    front = z > near                     # (T, 3)
    num_front = front.sum(dim=1)         # (T,)
    all_behind = num_front == 0          # render.swift:269 cull
    all_front = num_front == 3
    straddle = ~all_behind & ~all_front

    # The unique same-side edge s: front[s] == front[s+1] (render.swift:181-185);
    # argmax returns the first maximal index, as jnp.argmax does.
    same = front == _rot1(front)         # (T, 3)
    s = same.to(torch.int8).argmax(dim=1).to(torch.int32)
    nxt = (s + 1) % 3
    prc = (s + 2) % 3
    corner = torch.arange(3, dtype=torch.int32, device=cv.device)[None, :]
    is_s = corner == s[:, None]
    is_nxt = corner == nxt[:, None]
    is_prc = corner == prc[:, None]

    two_front = straddle & (front & is_s).any(dim=1)         # newTriangle flag

    # All three edge crossings, computed unconditionally (render.swift:186-199).
    z_next = _rot1(z)
    a = (near - z) / (z_next - z)                            # (T, 3)
    a3 = a[..., None]
    xcv = cv * (1 - a3) + _rot1(cv) * a3                     # (T, 3, 3)
    xattr = attr * (1 - a3) + _rot1(attr) * a3
    xn = n * (1 - a3) + _rot1(n) * a3
    # Divide by a tensor of ``near``, not by the Python float: PyTorch's CUDA
    # kernels turn division by a CPU scalar into multiplication by its
    # reciprocal, which rounds unlike the CPU's (and XLA's) true division.
    near_z = torch.full(xcv.shape[:2], near, dtype=cv.dtype, device=cv.device)
    xrv = torch.stack(
        [xcv[..., 0] * factor / near_z + half_w,
         -xcv[..., 1] * factor / near_z + half_h,
         near_z],
        dim=-1)

    # Primary slot: per-corner source index and orig-vs-crossing selector.
    one_front = straddle & ~two_front
    use_x = ((two_front[:, None] & is_prc)                   # -> crossing[nxt]
             | (one_front[:, None] & (is_s | is_nxt)))
    src = corner.expand(t, 3)
    src = torch.where(two_front[:, None] & is_prc, nxt[:, None], src)
    src = torch.where(one_front[:, None] & is_s, prc[:, None], src)
    src = torch.where(one_front[:, None] & is_nxt, nxt[:, None], src)

    # Appended slot: corners [orig s, crossing nxt, crossing prc]
    # (render.swift:202-222).
    sec_src = torch.stack([s, nxt, prc], dim=1)              # (T, 3)
    sec_use_x = corner > 0                                   # [F, T, T]

    out = {}
    for k, orig, crossing in (("cv", cv, xcv), ("rv", rv, xrv),
                              ("attr", attr, xattr), ("n", n, xn)):
        prim = torch.where(use_x[..., None], _gather3(crossing, src),
                           _gather3(orig, src))
        sec = torch.where(sec_use_x[..., None], _gather3(crossing, sec_src),
                          _gather3(orig, sec_src))
        # Interleave: slot 2t = primary, 2t+1 = appended.
        out[k] = torch.stack([prim, sec], dim=1).reshape(2 * t, 3, 3)
    out["tex"] = torch.stack([tex, tex], dim=1).reshape(2 * t)
    out["valid"] = torch.stack([~all_behind, two_front], dim=1).reshape(2 * t)
    return out
