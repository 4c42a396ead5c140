"""Render the same frame on every backend of the port and report agreement
with the golden oracle and speed (counterpart of
``examples/compare_backends.py``).

Usage:
    python -m swift3drenderer_tpu_torch.examples.compare_backends \\
        [scene] [WxH] [--device cuda|cpu] [--sampling nearest|bilinear]

Each backend (``cuda``: the hand-written kernels; ``xla``: the portable
banded rasterizer, both on ``--device``; ``native``: the C++ core on the
host, the JAX example's third backend) renders the scene at the identity
camera, once to warm up (build, capture) and once timed; its pixel mismatch
against golden at tol 1 must stay under 0.2 % (0.3 % bilinear). Exits 1
when a backend does not.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from ..camera import Camera, Input
from ..config import RenderConfig
from ..golden import render_frame as golden_render
from ..models import SCENES
from ..renderer import BACKENDS, NATIVE, Renderer

# Every backend of ``Renderer``: the device ones, then the host core.
ALL_BACKENDS = (*BACKENDS, NATIVE)

BOUND = {"nearest": 0.002, "bilinear": 0.003}


def mismatch(a: np.ndarray, b: np.ndarray, tol: int = 1) -> float:
    """Fraction of pixels whose packed RGB differs by more than ``tol`` in
    any channel."""
    def ch(p):
        p = p.astype(np.int64)
        return np.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], -1)
    return float((np.abs(ch(a) - ch(b)).max(-1) > tol).mean())


def compare(scene, width: int, height: int, *, device="cuda",
            config: RenderConfig = RenderConfig()) -> Dict[str, dict]:
    """Golden's host ms, and each backend's ms and mismatch against golden
    at the identity camera (``native`` on the host whatever ``device``)."""
    m = Camera().update(Input(), force_update=True)
    t0 = time.perf_counter()
    golden_px, _ = golden_render(scene, m, width, height, config)
    out = {"golden": {"ms": (time.perf_counter() - t0) * 1e3}}
    for backend in ALL_BACKENDS:
        r = Renderer(scene, config, device=device, backend=backend)
        r.render(m, width, height)          # build / capture
        t0 = time.perf_counter()
        px, _ = r.render(m, width, height)
        out[backend] = {"ms": (time.perf_counter() - t0) * 1e3,
                        "mismatch": mismatch(golden_px, px)}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.examples.compare_backends")
    p.add_argument("scene", nargs="?", default="default", choices=sorted(SCENES))
    p.add_argument("size", nargs="?", default="640x480", metavar="WxH")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--sampling", default="nearest",
                   choices=["nearest", "bilinear"])
    args = p.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    res = compare(SCENES[args.scene](seed=0), w, h, device=args.device,
                  config=RenderConfig(sampling=args.sampling))
    print(f"golden (NumPy oracle): {res['golden']['ms']:8.1f} ms")
    ok = True
    for backend in ALL_BACKENDS:
        r = res[backend]
        ok &= r["mismatch"] < BOUND[args.sampling]
        where = "host" if backend == NATIVE else args.device
        print(f"{backend} ({where}, {args.sampling}) {r['ms']:8.1f} ms   "
              f"pixel mismatch vs golden: {r['mismatch'] * 100:.3f}%")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
