"""Where a frame's time goes, stage by stage: the counterpart of the repo's
``tools/perf_probe.py``.

Each stage is a function of one camera pose, run over bench.py's flight
(``Input(up=1.0, mouse=(2i, 0))``, ``frames`` poses), and reports ms a frame:

  frontend  ``build_setup``, the route's binner (``bin_triangles`` up to
            ``FLAT_MAX_SLOTS`` slots, else ``bin_segments`` and
            ``pack_slot_records``) and ``pack_setup_tables``: no raster launch
  grid      the full frame over the setup table with ``live`` zeroed (on the
            device, inside the stage): the kernel's cost with nothing to draw
  vis       front-end, binning and the kernel's ``phases="vis"`` form
  shade     the same with the ``"shade"`` form (no texel fetch)
  full      the whole frame (``rasterize``), which equals ``Renderer.render``

On the card each stage is captured once in a CUDA graph of its own
(``graphs.FrameGraphs``) and replayed back to back over the poses, the poses
already on the card, timed with CUDA events: no stage reads the host inside
its window. The time of a graph that only takes the pose in (``m.sum()``) is
subtracted, as the JAX tool subtracts its empty chain; each stage's time is
the best of three windows. On ``--device cpu`` the stages run eagerly on the
CPU through the kernels' plain versions, timed with the host's clock: those
are CPU times, not the card's.

    python -m swift3drenderer_tpu_torch.tools.perf_probe [--scene default]
        [--frames 20] [--configs 1920x1080,3840x2160] [--objects 0]
        [--device cuda|cpu]

The JAX tool's ``--tile-h`` picks the TPU kernel's tile height; the port's
tile is fixed (``ops.raster.TILE_W`` x ``TILE_H``), so it has no such flag.
``tools.stress_probe`` runs the same stages on the large-scene route.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..camera import Camera, Input
from ..config import DEFAULT_CONFIG, RenderConfig
from ..convert import resolve_device
from ..graphs import FrameGraphs
from ..models import SCENES
from ..ops import raster
from ..renderer import build_setup, scene_to_device
from ..utils.databin import Scene

Stage = Callable[..., tuple]


def setup_stage(dev, m, *, width: int, height: int, config: RenderConfig):
    """The geometry front-end alone: the setup table."""
    return tuple(build_setup(dev, m, width=width, height=height,
                             config=config).values())


def frontend_stage(dev, m, *, width: int, height: int, config: RenderConfig):
    """The front-end through the binner and the packed tables: every input
    of the raster launch, and no launch."""
    setup = build_setup(dev, m, width=width, height=height, config=config)
    tables = raster.pack_setup_tables(setup)
    if setup["live"].shape[-1] <= raster.FLAT_MAX_SLOTS:
        return (*raster.bin_triangles(setup, width=width, height=height,
                                      tile_h=raster.TILE_H,
                                      tile_w=raster.TILE_W), *tables)
    return (*raster.bin_segments(setup, width=width, height=height), *tables,
            raster.pack_slot_records(setup))


def raster_stage(phases: str, dead: bool = False) -> Stage:
    """The frame through the kernel's form ``phases``; ``dead`` zeroes the
    setup table's ``live`` first (the ``grid`` stage)."""
    def stage(dev, m, *, width: int, height: int, config: RenderConfig):
        setup = build_setup(dev, m, width=width, height=height, config=config)
        if dead:
            setup = dict(setup, live=torch.zeros_like(setup["live"]))
        return raster.rasterize(setup, dev["textures"], width=width,
                                height=height,
                                background=config.background_packed,
                                sampling=config.sampling, phases=phases)
    return stage


def pose_stage(dev, m, *, width: int, height: int, config: RenderConfig):
    """Only the pose: the time every stage's replay spends taking it in."""
    return (m.sum(),)


STAGES: Dict[str, Stage] = {
    "setup": setup_stage,
    "frontend": frontend_stage,
    "grid": raster_stage("full", dead=True),
    "vis": raster_stage("vis"),
    "shade": raster_stage("shade"),
    "full": raster_stage("full"),
    "pose": pose_stage,
}
# The stages this tool reports, in its line's order.
PROBE_STAGES = ("frontend", "grid", "vis", "shade", "full")
WINDOWS = 3


def flight(frames: int, config: RenderConfig = DEFAULT_CONFIG) -> np.ndarray:
    """bench.py's flight: (frames, 3, 4) float32 poses."""
    cam = Camera(config)
    return np.stack([cam.update(Input(up=1.0, mouse=(2.0 * i, 0.0)),
                                force_update=(i == 0)).copy()
                     for i in range(frames)]).astype(np.float32)


class Stages:
    """The stages of one scene at one frame size on one device. On the card
    ``run`` replays a stage's graph (captured at its first call) and
    ``times`` replays it over a flight; on the CPU both run eagerly."""

    def __init__(self, scene: Scene, width: int, height: int, device="cuda",
                 config: RenderConfig = DEFAULT_CONFIG) -> None:
        self.device = resolve_device(device)
        self.width, self.height, self.config = width, height, config
        self.dev = scene_to_device(scene, self.device)
        self.graphs = (FrameGraphs(self.device) if self.device.type == "cuda"
                       else None)

    def _call(self, name: str, pose: torch.Tensor) -> tuple:
        stage = STAGES[name]

        def frame(x):
            return stage(self.dev, x.view(3, 4), width=self.width,
                         height=self.height, config=self.config)

        if self.graphs is None:
            return frame(pose)
        return self.graphs.run((name, self.width, self.height), frame, pose)

    def run(self, name: str, m) -> tuple:
        """Stage ``name``'s outputs at pose ``m`` (3, 4). On the card the
        graph's outputs: its next replay overwrites them."""
        pose = torch.as_tensor(np.asarray(m, np.float32)).to(self.device)
        return self._call(name, pose.reshape(-1))

    def _ms(self, name: str, poses: torch.Tensor) -> float:
        """The best window's ms a pose of stage ``name`` over ``poses`` (n,
        12) on the device, after one warm pass (which captures on the
        card)."""
        def flight_pass():
            for p in poses:
                self._call(name, p)

        flight_pass()
        best = float("inf")
        for _ in range(WINDOWS):
            if self.graphs is None:
                t0 = time.perf_counter()
                flight_pass()
                ms = (time.perf_counter() - t0) * 1e3
            else:
                torch.cuda.synchronize(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                flight_pass()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            best = min(best, ms / len(poses))
        return best

    def times(self, names: Sequence[str], poses: np.ndarray) -> Dict[str, float]:
        """ms a frame of each stage over ``poses`` (n, 3, 4), less the
        pose-only graph's, at least 0."""
        flat = torch.as_tensor(np.asarray(poses, np.float32).reshape(
            len(poses), 12)).to(self.device)
        overhead = self._ms("pose", flat)
        return {name: max(self._ms(name, flat) - overhead, 0.0)
                for name in names}


def make_scene(scene_name: str, objects: int = 0) -> Scene:
    kwargs = {"objects": objects} if objects else {}
    return SCENES[scene_name](seed=0, **kwargs)


def probe(scene_name: str, width: int, height: int, frames: int,
          objects: int = 0, device="cuda") -> Dict[str, float]:
    """ms a frame of ``frontend``, ``grid``, ``vis``, ``shade`` and
    ``full`` for scene ``scene_name`` (``objects`` for the stress scene, 0
    for its default) at width x height over ``frames`` poses."""
    stages = Stages(make_scene(scene_name, objects), width, height, device)
    return stages.times(PROBE_STAGES, flight(frames))


def device_line(device) -> str:
    """What the times were taken on."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"device: {torch.cuda.get_device_name(dev)} (CUDA events)"
    return "device: cpu (host clock; plain versions of the kernels)"


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    p = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.tools.perf_probe")
    p.add_argument("--scene", default="default")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--configs", default="1920x1080,3840x2160")
    p.add_argument("--objects", type=int, default=0,
                   help="object count for --scene stress (0 = scene default)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    print(device_line(args.device), flush=True)
    out = {}
    for wh in args.configs.split(","):
        w, h = map(int, wh.split("x"))
        r = probe(args.scene, w, h, args.frames, objects=args.objects,
                  device=args.device)
        out[wh] = r
        print(f"{args.scene} {w}x{h}: "
              f"frontend {r['frontend']:.3f} | grid {r['grid']:.3f} | "
              f"vis {r['vis']:.3f} | +shade {r['shade']:.3f} | "
              f"full {r['full']:.3f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
