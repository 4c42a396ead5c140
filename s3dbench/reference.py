"""The plain reference renderer, and the comparison that decides ``correct``.

Plain PyTorch, written from the upstream's frame (render/render.swift:229-344,
render-cpp/render.cpp:265-384) and nothing of the program under test: the
camera-space transform, the near-plane clip with its triangle split (a
triangle with two corners in front becomes two, the second appended after
every original triangle, render.swift:177-227), the screen and area culls,
the closed-form barycentric weights at pixel centres, the 1/z depth test in
which the earliest triangle keeps a tie, perspective-correct interpolation,
the halfway-vector headlight, and the flat colour or the anisotropic ripmap
fetch (nearest, render.swift:94-111, or bilinear within the selected level).

Instead of the upstream's loop over triangles it walks every (pixel,
triangle) pair inside each triangle's screen box, in chunks: the deepest 1/z
of every pixel, then the first triangle that reaches it, then the winner's
shading. So a 4K frame of ten thousand triangles takes a fraction of a
second on the card. Every float is computed in ``dtype``: float32 is the
reference; bfloat16 is the control, the reference one precision down.

The same pass counts the work a rasterizer has to do for the frame, whatever
its binning (``Work``): triangles that survive the culls, (pixel, triangle)
pairs inside their boxes, drawn pixels, and the distinct atlas words the drawn
textured pixels fetch. ``roofline`` turns these into bytes and operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

CHUNK = 1 << 22            # (pixel, triangle) pairs a chunk
ATLAS = 512


@dataclasses.dataclass
class Work:
    """What one frame asks of a rasterizer, counted from its inputs."""

    slots: int = 0          # triangles after the clip that pass the culls
    box_pairs: int = 0      # (pixel, triangle) pairs inside their boxes
    drawn: int = 0          # pixels with a winner
    atlas_words: torch.Tensor = None   # distinct atlas words fetched


def _edge(ax, ay, bx, by, cx, cy):
    """Signed parallelogram area (render.swift:89-92)."""
    return (cx - ax) * (ay - by) + (cy - ay) * (bx - ax)


def _norm3(x, y, z):
    n = torch.sqrt(x * x + y * y + z * z)
    return x / n, y / n, z / n


class Reference:
    """A scene on ``device`` and the render constants of its configuration
    (``render`` key: near, fov_rad, min_area, background_rgb)."""

    def __init__(self, scene: Dict[str, np.ndarray], render: dict, device,
                 dtype=torch.float32) -> None:
        self.device = torch.device(device)
        self.dtype = dtype
        self.near = float(render["near"])
        self.fov = float(render["fov_rad"])
        self.min_area = float(render["min_area"])
        r, g, b = (int(c) & 0xFF for c in render["background_rgb"])
        self.background = (r << 16) | (g << 8) | b

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device).to(dtype)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

        self.vertices = f(scene["vertices"])
        self.normals = f(scene["normals"])
        self.attr_vec = f(scene["attr_vec"])
        self.attr_tex = i64(scene["attr_tex"])
        self.vi = i64(scene["vertex_indices"]).reshape(-1, 3)
        self.ai = i64(scene["attribute_indices"]).reshape(-1, 3)
        self.textures = torch.as_tensor(
            np.asarray(scene["textures"], np.uint32).astype(np.int64),
            device=self.device)                      # (NT, 512, 512)

    # -- geometry --------------------------------------------------------

    def _jobs(self, m: torch.Tensor, width: int, height: int):
        """Corner arrays of every triangle after the near-plane clip, the
        appended halves after the originals, and which of them survive."""
        dt = self.dtype
        near = torch.tensor(self.near, dtype=dt, device=self.device)
        factor = self.near * height / (2.0 * self.near * math.tan(self.fov / 2))
        half_w, half_h = width / 2.0, height / 2.0

        def times_mt(x):        # x (N, 4) @ m.T, summed left to right
            return (x[:, 0:1] * m[:, 0] + x[:, 1:2] * m[:, 1]
                    + x[:, 2:3] * m[:, 2] + x[:, 3:4] * m[:, 3])

        cv_v = times_mt(self.vertices)
        z_v = -cv_v[:, 2]
        rv_v = torch.stack([cv_v[:, 0] * factor / z_v + half_w,
                            -cv_v[:, 1] * factor / z_v + half_h, z_v], dim=1)
        n_a = times_mt(self.normals)
        cv, rv = cv_v[self.vi], rv_v[self.vi]                  # (T, 3, 3)
        attr, nrm = self.attr_vec[self.ai], n_a[self.ai]
        tex = self.attr_tex[self.ai[:, 0]]
        t = cv.shape[0]

        z = rv[..., 2]
        front = z > near
        behind = ~front.any(dim=1)                             # swift:269
        straddle = ~behind & (z.amin(dim=1) < near)
        same = front == front.roll(-1, dims=1)
        s = same.to(torch.int8).argmax(dim=1)                  # swift:181-185
        nxt, prc = (s + 1) % 3, (s + 2) % 3
        rows = torch.arange(t, device=self.device)
        two_front = straddle & front[rows, s]

        # The crossing on every edge i -> i + 1 (render.swift:186-199).
        a = ((near - z) / (z.roll(-1, dims=1) - z))[..., None]
        xcv = cv * (1 - a) + cv.roll(-1, dims=1) * a
        xrv = torch.stack([xcv[..., 0] * factor / near + half_w,
                           -xcv[..., 1] * factor / near + half_h,
                           near.expand(xcv.shape[:2])], dim=-1)
        xattr = attr * (1 - a) + attr.roll(-1, dims=1) * a
        xn = nrm * (1 - a) + nrm.roll(-1, dims=1) * a

        corner = torch.arange(3, device=self.device)[None, :, None]
        one_front = (straddle & ~two_front)[:, None, None]
        two = two_front[:, None, None]
        use_next = ((two & (corner == prc[:, None, None]))
                    | (one_front & (corner == nxt[:, None, None])))
        use_prec = one_front & (corner == s[:, None, None])
        app = torch.nonzero(two_front).reshape(-1)
        out = []
        for orig, cross in ((cv, xcv), (rv, xrv), (attr, xattr), (nrm, xn)):
            x_next = cross[rows, nxt][:, None, :]
            x_prec = cross[rows, prc][:, None, :]
            prim = torch.where(use_next, x_next,
                               torch.where(use_prec, x_prec, orig))
            sec = torch.cat([orig[app, s[app]][:, None], x_next[app],
                             x_prec[app]], dim=1)
            out.append(torch.cat([prim, sec]))
        cv, rv, attr, nrm = out
        tex = torch.cat([tex, tex[app]])
        kept = torch.cat([~behind, torch.ones_like(app, dtype=torch.bool)])

        rvmax, rvmin = rv.amax(dim=1), rv.amin(dim=1)
        area = _edge(rv[:, 0, 0], rv[:, 0, 1], rv[:, 1, 0], rv[:, 1, 1],
                     rv[:, 2, 0], rv[:, 2, 1])
        live = (kept & (rvmax[:, 0] >= 0) & (rvmax[:, 1] >= 0)
                & (rvmin[:, 0] < width) & (rvmin[:, 1] < height)
                & (area >= self.min_area))                     # swift:274-280
        idx = torch.nonzero(live).reshape(-1)
        return dict(cv=cv[idx], rv=rv[idx], attr=attr[idx], n=nrm[idx],
                    tex=tex[idx], area=area[idx], rvmin=rvmin[idx],
                    rvmax=rvmax[idx])

    def _setup(self, j: dict, width: int, height: int) -> dict:
        """Per-triangle constants (render.swift:281-311)."""
        rv = j["rv"]
        ooa = 1.0 / j["area"]
        x0, y0, x1, y1, x2, y2 = (rv[:, c, k] for c in range(3) for k in range(2))
        p = 0.5
        w00 = torch.stack([_edge(x1, y1, x2, y2, p, p), _edge(x2, y2, x0, y0, p, p),
                           _edge(x0, y0, x1, y1, p, p)], dim=1) * ooa[:, None]
        dx = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=1) * ooa[:, None]
        dy = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=1) * ooa[:, None]
        rvz = 1.0 / rv[..., 2]
        # int(max(0, rvmin)), int(min(W - 1, rvmax)), the limits applied
        # again to the integers: W - 1 may not be exact in ``dtype``.
        def box(v, lo, hi):
            return torch.clamp(v, lo, hi).to(torch.int64).clamp(lo, hi)

        xmin = box(j["rvmin"][:, 0], 0, width - 1)
        xmax = box(j["rvmax"][:, 0], 0, width - 1)
        ymin = box(j["rvmin"][:, 1], 0, height - 1)
        ymax = box(j["rvmax"][:, 1], 0, height - 1)
        return dict(w00=w00, dx=dx, dy=dy, rvz=rvz,
                    cvp=j["cv"] * rvz[..., None], np=j["n"] * rvz[..., None],
                    attrp=j["attr"] * rvz[..., None], tex=j["tex"],
                    x0=xmin, y0=ymin, bw=(xmax - xmin + 1).clamp(min=0),
                    bh=(ymax - ymin + 1).clamp(min=0))

    def _weights(self, st: dict, j: torch.Tensor, px: torch.Tensor,
                 py: torch.Tensor):
        """Barycentric weights and 1/z of triangles ``j`` at pixels (px, py)."""
        pxf, pyf = px.to(self.dtype), py.to(self.dtype)
        w = [st["w00"][j, k] + pxf * st["dx"][j, k] + pyf * st["dy"][j, k]
             for k in range(3)]
        rvz = st["rvz"][j]
        ooz = w[0] * rvz[:, 0] + w[1] * rvz[:, 1] + w[2] * rvz[:, 2]
        return w, ooz

    # -- one frame -------------------------------------------------------

    def render(self, pose: np.ndarray, width: int, height: int,
               sampling: str) -> Tuple[torch.Tensor, torch.Tensor, Work]:
        """(pixels (H, W) int32 0x00RRGGBB, 1/z (H, W) float32, 0 where
        nothing covers; the frame's ``Work``)."""
        m = torch.as_tensor(np.asarray(pose, np.float32),
                            device=self.device).to(self.dtype)
        j = self._jobs(m, width, height)
        st = self._setup(j, width, height)
        npx = width * height
        count = st["bw"] * st["bh"]
        ends = torch.cumsum(count, 0)
        total = int(ends[-1]) if ends.numel() else 0
        starts = ends - count

        def pairs():
            for a in range(0, total, CHUNK):
                i = torch.arange(a, min(a + CHUNK, total), device=self.device)
                k = torch.searchsorted(ends, i, right=True)
                loc = i - starts[k]
                px = st["x0"][k] + loc % st["bw"][k]
                py = st["y0"][k] + loc // st["bw"][k]
                w, ooz = self._weights(st, k, px, py)
                ok = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0) & (ooz > 0)
                yield k[ok], (py * width + px)[ok], ooz[ok].float()

        depth = torch.zeros(npx, dtype=torch.float32, device=self.device)
        for _, pix, ooz in pairs():
            depth.scatter_reduce_(0, pix, ooz, reduce="amax")
        none = torch.iinfo(torch.int64).max
        win = torch.full((npx,), none, dtype=torch.int64, device=self.device)
        for k, pix, ooz in pairs():
            top = ooz == depth[pix]
            win.scatter_reduce_(0, pix[top], k[top], reduce="amin")

        out = torch.full((npx,), self.background, dtype=torch.int64,
                         device=self.device)
        where = torch.nonzero(win != none).reshape(-1)
        k = win[where]
        rgb, words = self._shade(st, k, where % width, where // width, sampling)
        out[where] = ((rgb[0] << 16) | (rgb[1] << 8) | rgb[2])
        work = Work(slots=int(count.numel()), box_pairs=total,
                    drawn=int(where.numel()),
                    atlas_words=torch.unique(words))
        return (out.to(torch.int32).reshape(height, width),
                depth.reshape(height, width), work)

    def _shade(self, st: dict, k, px, py, sampling: str):
        """Packed channels of the winners ``k`` at (px, py) and the atlas
        words their textured pixels fetch (render.swift:326-330)."""
        w, ooz = self._weights(st, k, px, py)
        wt = [wk / ooz for wk in w]

        def interp(name):
            c = st[name][k]                                   # (n, 3, 3)
            return [wt[0] * c[:, 0, i] + wt[1] * c[:, 1, i] + wt[2] * c[:, 2, i]
                    for i in range(3)]

        p = _norm3(*(-v for v in interp("cvp")))
        n = _norm3(*interp("np"))
        h = _norm3(p[0] + n[0], p[1] + n[1], p[2] + n[2])
        shade = h[0] * n[0] + h[1] * n[1] + h[2] * n[2]
        color = interp("attrp")

        tex = st["tex"][k]
        tx = torch.nonzero(tex >= 0).reshape(-1)
        words = torch.zeros(0, dtype=torch.int64, device=self.device)
        if tx.numel():
            kt = k[tx]
            rvz, dx, dy = st["rvz"][kt], st["dx"][kt], st["dy"][kt]
            uvp = st["attrp"][kt][..., :2]
            dz = [rvz[:, 0] * d[:, 0] + rvz[:, 1] * d[:, 1] + rvz[:, 2] * d[:, 2]
                  for d in (dx, dy)]
            tpp = [uvp[:, 0, 0] * dx[:, 0] + uvp[:, 1, 0] * dx[:, 1]
                   + uvp[:, 2, 0] * dx[:, 2],
                   uvp[:, 0, 1] * dy[:, 0] + uvp[:, 1, 1] * dy[:, 1]
                   + uvp[:, 2, 1] * dy[:, 2]]
            uv = [color[0][tx], color[1][tx]]
            level = [ooz[tx] / torch.abs(tpp[a] - uv[a] * dz[a]) for a in (0, 1)]
            sample = self._nearest if sampling == "nearest" else self._bilinear
            rgb, words = sample(tex[tx], uv, level)
            for c in range(3):
                color[c] = color[c].clone()
                color[c][tx] = rgb[c]
        packed = [torch.nan_to_num(shade * c, nan=0.0).to(torch.int64) & 0xFF
                  for c in color]
        return packed, words

    # -- ripmap fetch ----------------------------------------------------

    @staticmethod
    def _level(level):
        lv = torch.clamp(torch.nan_to_num(level, nan=256.0, posinf=256.0,
                                          neginf=1.0), 1.0, 256.0)
        li = lv.to(torch.int64) - 1
        li = li | (li >> 1)
        li = li | (li >> 2)
        li = li | (li >> 4)
        return li + 1

    def _fetch(self, tex, x, y):
        words = (tex * ATLAS + y) * ATLAS + x
        rgb = self.textures.reshape(-1)[words]
        return [((rgb >> sh) & 0xFF).to(self.dtype) for sh in (16, 8, 0)], words

    def _nearest(self, tex, uv, level):
        """render.swift:104-111: the texel under the coordinate in the
        per-axis power-of-two level, stored at offset 512 - 2L."""
        idx = []
        for a in (0, 1):
            lp = self._level(level[a])
            frac = torch.fmod(torch.nan_to_num(uv[a]), 1.0)
            t = (frac * lp.to(self.dtype)).to(torch.int64)
            idx.append(torch.clamp(t + (511 & ~(2 * lp - 1)), 0, ATLAS - 1))
        return self._fetch(tex, idx[0], idx[1])

    def _bilinear(self, tex, uv, level):
        """Bilinear within the selected level: texel centres at +0.5,
        coordinates wrapped, the four taps blended by their weights."""
        taps, wts = [], []
        for a in (0, 1):
            lp = self._level(level[a])
            frac = torch.remainder(torch.nan_to_num(uv[a]), 1.0)
            t = frac * lp.to(self.dtype) - 0.5
            t0 = torch.floor(t)
            wts.append(t - t0)
            off = 511 & ~(2 * lp - 1)
            t0 = t0.to(torch.int64)
            taps.append([torch.clamp((t0 + d) % lp + off, 0, ATLAS - 1)
                         for d in (0, 1)])
        (x0, x1), (y0, y1) = taps
        wx, wy = wts
        c00, a00 = self._fetch(tex, x0, y0)
        c10, a10 = self._fetch(tex, x1, y0)
        c01, a01 = self._fetch(tex, x0, y1)
        c11, a11 = self._fetch(tex, x1, y1)
        rgb = [(1 - wx) * (1 - wy) * c00[c] + wx * (1 - wy) * c10[c]
               + (1 - wx) * wy * c01[c] + wx * wy * c11[c] for c in range(3)]
        return rgb, torch.cat([a00, a10, a01, a11])


def mismatch(pix: torch.Tensor, depth: torch.Tensor, ref_pix: torch.Tensor,
             ref_depth: torch.Tensor, tol: int = 1, rtol: float = 1e-4) -> float:
    """Share of a frame's pixels that differ from the reference's: a colour
    channel off by more than ``tol``, a pixel covered on one side only, or
    1/z off by more than ``rtol`` of the reference's."""
    a = pix.to(ref_pix.device, torch.int64)
    b = ref_pix.to(torch.int64)
    depth = depth.to(ref_depth.device)
    off = torch.zeros_like(a, dtype=torch.bool)
    for sh in (16, 8, 0):
        off |= (((a >> sh) & 0xFF) - ((b >> sh) & 0xFF)).abs() > tol
    off |= (depth > 0) != (ref_depth > 0)
    off |= (depth - ref_depth).abs() > rtol * ref_depth.abs()
    return float(off.float().mean())


def mismatch_pixels(pix: torch.Tensor, ref_pix: torch.Tensor, background: int,
                    tol: int = 1) -> float:
    """``mismatch`` for a frame handed back without its depth: a colour
    channel off by more than ``tol``, or a pixel covered on one side only,
    a pixel being covered where it is not the background colour."""
    a = pix.to(ref_pix.device, torch.int64)
    b = ref_pix.to(torch.int64)
    off = torch.zeros_like(a, dtype=torch.bool)
    for sh in (16, 8, 0):
        off |= (((a >> sh) & 0xFF) - ((b >> sh) & 0xFF)).abs() > tol
    off |= (a != background) != (b != background)
    return float(off.float().mean())
