"""One run of one cell: build, warm up, measure, trace, check, report.

``python3 s3dbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (see README.md). In order:

1. set-up, timed from the start of ``run.py`` to the first timed call: the
   cell's scene and flight from the seed (``scenegen``, ``flight``), the
   program's ``Renderer`` on the card (its first call builds or loads the
   raster library into the package's ``_build/`` and captures the cell's
   CUDA graph), and ``warmup_s`` of the cell's traffic;
2. the window: the cell's client for ``--seconds``, the program's graph
   captures counted before and after (none may happen inside it), the
   card's clocks read once a second (``clocks``);
3. with ``--trace 1``, ``trace_calls`` calls under the profiler to let it
   settle, then a traced window of ``trace_calls`` calls between two marker
   kernels (``tracing``);
4. the check, once the program is closed: a sample of the window's frames,
   drawn from the seed, against the plain reference (``reference``), and the
   work of the traced frames (``roofline``);
5. one JSON line: the end-to-end metrics, or with ``--trace 1`` the
   per-layer ones, each read by ``metrics/<name>.py``.

Three clients (the traffic's ``client``): ``frame`` asks for one frame with
``Renderer.render_device`` and waits for it before asking for the next;
``batch`` keeps ``in_flight`` ``Renderer.render_batch`` calls of ``batch``
poses in flight, waiting on the event of the call ``in_flight`` back before
it issues the next; ``app`` drives the app's own loop, one
``FrameLoop.step`` a call with the walk's input for that frame, in the
walk's order from a frame the seed draws (``AppClient``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import clocks, flight, reference, roofline, scenegen, spec, tracing

FORBIDDEN = {"jax", "jaxlib", "flax", "swift3drenderer_tpu"}


class NoCard(RuntimeError):
    """The run cannot measure: no card, or fewer than the cell asks for."""


@dataclasses.dataclass
class Window:
    """What a client did in one window."""

    seconds: float = 0.0
    calls: int = 0
    frames: int = 0
    entry_s: float = 0.0           # host seconds inside the program's calls


class Reservoir:
    """A uniform sample of ``k`` calls of a window, drawn from ``seed``
    (algorithm R): each entry (poses (B, 3, 4), pixels, depth).
    ``own(out, j)`` makes a call kept in entry j the sample's own; it runs
    only for a call that is kept."""

    def __init__(self, k: int, seed: int,
                 own: Optional[Callable] = None) -> None:
        self.k, self.rng, self.items = k, random.Random(seed), []
        self.own = own or (lambda out, j: out)

    def __call__(self, n: int, poses, out) -> None:
        if n < self.k:
            self.items.append((poses, *self.own(out, n)))
            return
        j = self.rng.randrange(n + 1)
        if j < self.k:
            self.items[j] = (poses, *self.own(out, j))


def call_poses(poses: np.ndarray, order: np.ndarray, batch: int,
               n: int) -> np.ndarray:
    """The (B, 3, 4) poses of a client's n-th call: the flight in the run's
    order, cycled."""
    i = (n * batch + np.arange(batch)) % len(order)
    return poses[order[i]]


class Client:
    """The cell's traffic against one ``Renderer``."""

    own = None            # what the entry points return is the caller's

    def __init__(self, renderer, poses: np.ndarray, order: np.ndarray,
                 traffic: dict) -> None:
        self.r, self.poses, self.order = renderer, poses, order
        self.w, self.h = traffic["width"], traffic["height"]
        self.kind = traffic["client"]
        self.batch = traffic.get("batch", 1)
        self.in_flight = traffic.get("in_flight", 1)
        if self.kind not in ("frame", "batch"):
            raise ValueError(f"unknown client {self.kind!r}")
        # The calls' poses, one cycle of the flight, made before any window.
        cycle = len(order) // math.gcd(len(order), self.batch)
        self.calls = [call_poses(poses, order, self.batch, n)
                      for n in range(cycle)]

    def run(self, *, seconds: float = 0.0, calls: int = 0,
            keep: Optional[Callable] = None,
            clock: Optional[clocks.Clocks] = None) -> Window:
        """Calls until ``seconds`` have passed and at least ``calls`` are
        done; ``keep(n, poses, (pixels, depth))`` sees every call and
        ``clock`` reads the card's clocks between calls."""
        win = Window()
        if clock is not None:
            clock.start()
        deadline = time.perf_counter() + seconds
        t0 = time.perf_counter()
        ring = [torch.cuda.Event() for _ in range(self.in_flight)]
        while True:
            slot = ring[win.calls % self.in_flight]
            if self.kind == "batch" and win.calls >= self.in_flight:
                slot.synchronize()
            ms = self.calls[win.calls % len(self.calls)]
            h0 = time.perf_counter()
            if self.kind == "frame":
                out = self.r.render_device(ms[0], self.w, self.h)
            else:
                out = self.r.render_batch(ms, self.w, self.h)
            now = time.perf_counter()
            win.entry_s += now - h0
            slot.record()
            if self.kind == "frame":
                slot.synchronize()
                now = time.perf_counter()
            if keep:
                keep(win.calls, ms, out)
            win.calls += 1
            if clock is not None:
                clock.tick(now, win.calls, self.batch, win.entry_s)
            if win.calls >= calls and now >= deadline:
                break
        for e in ring:
            e.synchronize()
        win.seconds = time.perf_counter() - t0
        win.frames = win.calls * self.batch
        return win

    def poses_of(self, n: int) -> np.ndarray:
        """The (B, 3, 4) poses of a run's n-th call."""
        return self.calls[n % len(self.calls)]


def _pose_state(cam: flight.Camera) -> dict:
    """The benchmark camera's state in the form of the app's resume API
    (``camera.Camera.load_pose_state``)."""
    x, y, z = cam.axes
    return {"position": cam.position.tolist(), "axis_x": x.tolist(),
            "axis_y": y.tolist(), "axis_z": z.tolist(),
            "mouse": cam.mouse.tolist()}


class AppClient:
    """The app's own loop (``app.FrameLoop``) flying the walk in sequence.

    A call is one ``FrameLoop.step`` with the walk's input for that frame
    (``flight.inputs``: the keys and the accumulated mouse); it ends when
    ``step`` returns its host buffer. Every run starts at the walk frame
    ``start`` and flies on frame after frame. At its start, and each time
    the walk wraps, the client sets the app's camera to the benchmark's
    camera before that frame through the app's resume API
    (``FrameLoop.camera.load_pose_state``); in between the app's camera
    follows the inputs on its own. A kept call's poses are the benchmark's
    pose of that frame, so the app's camera is held to the benchmark's.

    ``step`` hands out the same host buffer again two frames later, so a
    kept call is copied into one of ``keep`` host buffers made and written
    once here, at set-up: the window allocates nothing of the benchmark's
    on the host beside the program's own allocations."""

    batch = 1

    def __init__(self, loop, frames: List[flight.Frame], poses: np.ndarray,
                 start: int, keep: int) -> None:
        from swift3drenderer_tpu_torch import Input

        self.loop, self.poses, self.start = loop, poses, start
        self.inputs = [Input(*f.keys, mouse=(float(f.mouse[0]),
                                             float(f.mouse[1])))
                       for f in frames]
        self.states = [_pose_state(f.before) for f in frames]
        self.kept = [np.zeros((loop.height, loop.width), np.int32)
                     for _ in range(keep)]
        for buf in self.kept:
            buf.fill(1)                 # its pages, before any window

    def own(self, out, j: int) -> tuple:
        """Call ``out`` = (host buffer,) kept in entry j: its copy as int32
        pixels, and no depth."""
        np.copyto(self.kept[j], out[0].view(np.int32))
        return torch.from_numpy(self.kept[j]), None

    def run(self, *, seconds: float = 0.0, calls: int = 0,
            keep: Optional[Callable] = None,
            clock: Optional[clocks.Clocks] = None) -> Window:
        """As ``Client.run``: calls until ``seconds`` have passed and at
        least ``calls`` are done."""
        win = Window()
        if clock is not None:
            clock.start()
        deadline = time.perf_counter() + seconds
        t0 = time.perf_counter()
        while True:
            i = (self.start + win.calls) % len(self.inputs)
            if win.calls == 0 or i == 0:
                self.loop.camera.load_pose_state(self.states[i])
            h0 = time.perf_counter()
            buf = self.loop.step(self.inputs[i])
            now = time.perf_counter()
            win.entry_s += now - h0
            if keep:
                keep(win.calls, self.poses[i:i + 1], (buf,))
            win.calls += 1
            if clock is not None:
                clock.tick(now, win.calls, self.batch, win.entry_s)
            if win.calls >= calls and now >= deadline:
                break
        win.seconds = time.perf_counter() - t0
        win.frames = win.calls
        return win

    def poses_of(self, n: int) -> np.ndarray:
        """The (1, 3, 4) pose of a run's n-th call."""
        return self.poses[(self.start + n) % len(self.poses)][None]


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/``)."""

    cell: spec.Cell
    setup_s: float
    window: Window
    batch: int
    trace: Optional[tracing.Trace] = None
    trace_attempts: int = 0
    traced_frames: int = 0
    launches: List[tuple] = dataclasses.field(default_factory=list)
    card: Optional[dict] = None


@dataclasses.dataclass
class Outcome:
    """The result line, and what a calibration reads besides."""

    line: dict
    scene: dict
    sample: list
    readings: List[float]


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _render_config(config: dict, sampling: str):
    from swift3drenderer_tpu_torch import RenderConfig

    r = config["render"]
    return RenderConfig(near=r["near"], fov=r["fov_rad"], min_area=r["min_area"],
                        background_rgb=tuple(float(c) for c in r["background_rgb"]),
                        sampling=sampling)


def _traced_window(client, calls: int, attempts: int = 3):
    """The trace of ``calls`` calls between two marker kernels, after as
    many calls under the profiler to let it settle, and the attempts it
    took. CUPTI drops activity records now and then (a marker was lost in
    one traced run of the 1080p frame cell on the H100): such a trace is
    taken again."""
    for attempt in range(1, attempts + 1):
        with tempfile.TemporaryDirectory() as tmp:
            with tracing.device_trace(tmp):
                client.run(calls=calls)
                tracing.mark()
                client.run(calls=calls)
                tracing.mark()
                torch.cuda.synchronize()
            try:
                return tracing.Trace(os.path.join(tmp, "trace.json")), attempt
            except tracing.Incomplete:
                if attempt == attempts:
                    raise


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: Optional[float] = None) -> Outcome:
    """One run of ``workload`` (module docstring)."""
    t0 = time.perf_counter() if t0 is None else t0
    parts = {"imports": time.perf_counter() - t0}
    cell = spec.cell(workload)
    tr = cell.traffic
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        raise NoCard(f"{workload} needs {cell.chips} CUDA card(s); this host "
                     f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    def mark(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    torch.cuda.init()
    clock = clocks.Clocks()
    mark("card")
    from swift3drenderer_tpu_torch import Renderer, Scene

    mark("program_import")
    scene = scenegen.build(cell.config, seed)
    poses = flight.walk(tr["flight"])
    order = flight.order(len(poses), seed)
    mark("scene_and_flight")
    config = _render_config(cell.config, tr["sampling"])
    if tr["client"] == "app":
        from swift3drenderer_tpu_torch.app import FrameLoop

        # The seed draws the walk frame the app's runs start at.
        client = AppClient(FrameLoop(Scene(**scene), tr["width"], tr["height"],
                                     config=config, device="cuda"),
                           flight.inputs(tr["flight"]), poses, int(order[0]),
                           cell.check["sample_calls"])
        r = client.loop.renderer
    else:
        r = Renderer(Scene(**scene), config=config, device="cuda")
        client = Client(r, poses, order, tr)
    mark("renderer")
    client.run(calls=1)
    mark("first_call")
    client.run(seconds=tr["warmup_s"], calls=1)
    captures = r.graphs.captures
    torch.cuda.synchronize()
    mark("warmup")
    setup_s = time.perf_counter() - t0

    sample = Reservoir(cell.check["sample_calls"], seed, client.own)
    window = client.run(seconds=seconds, calls=1, keep=sample, clock=clock)
    if r.graphs.captures != captures:
        raise RuntimeError(f"{r.graphs.captures - captures} graph capture(s) "
                           "inside the window")
    peak = torch.cuda.max_memory_allocated()

    run = Run(cell=cell, setup_s=setup_s, window=window, batch=client.batch)
    traced = []
    if trace:
        run.trace, run.trace_attempts = _traced_window(client, tr["trace_calls"])
        run.traced_frames = tr["trace_calls"] * client.batch
        traced = [client.poses_of(n) for n in range(tr["trace_calls"])]

    r.graphs.close()
    del r, client
    torch.cuda.empty_cache()

    # The check: every sampled frame against the reference's.
    ref = reference.Reference(scene, cell.config["render"], "cuda")
    w, h, sampling = tr["width"], tr["height"], tr["sampling"]
    readings, drawn = [], []
    for ms, pix, depth in sample.items:
        if pix.dim() == 2:                      # a frame or app client's call
            pix = pix[None]
            depth = None if depth is None else depth[None]
        for b in range(ms.shape[0]):
            rp, rd, work = ref.render(ms[b], w, h, sampling)
            readings.append(compare(cell.check, pix[b],
                                    None if depth is None else depth[b],
                                    rp, rd, ref.background))
            drawn.append(work.drawn)
    if trace:
        for ms in traced:
            works = [ref.render(m, w, h, sampling)[2] for m in ms]
            run.launches.append(roofline.launch_work(works, w, h, sampling))
        run.card = roofline.peak(torch.cuda.get_device_name())
    line = _line(run, readings, drawn, peak)
    line["setup_parts_s"] = parts
    line["clocks"] = clock.summary()
    line["check"] = line.pop("check")
    return Outcome(line=line, scene=scene, sample=sample.items,
                   readings=readings)


def compare(check: dict, pix: torch.Tensor, depth: Optional[torch.Tensor],
            ref_pix: torch.Tensor, ref_depth: torch.Tensor,
            background: int) -> float:
    """A frame's reading against the reference's: ``reference.mismatch``,
    or ``reference.mismatch_pixels`` where the program hands back no depth
    (the app's host buffer)."""
    if depth is None:
        return reference.mismatch_pixels(pix, ref_pix, background,
                                         check["tol"])
    return reference.mismatch(pix, depth, ref_pix, ref_depth, check["tol"],
                              check["rtol"])


def _line(run: Run, readings: List[float], drawn: List[int],
          peak: int) -> dict:
    """The result's JSON object; its ``check`` key comes last."""
    cell = run.cell
    metrics = {}
    for m in (cell.per_layer if run.trace is not None else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limit = cell.check["mismatch_max"]
    worst = max(readings) if readings else float("inf")
    failed = sum(x > limit for x in readings)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit_w": _power_limit()}
    line = {"correct": bool(readings) and worst <= limit,
            "attempted": run.window.frames, "failed": int(failed),
            "metrics": metrics, "device": device}
    if run.trace is not None:
        line["trace_attempts"] = run.trace_attempts
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["drawn_px_per_frame"] = (float(np.mean(drawn)) if drawn else 0.0)
    line["check"] = {"mismatch_max": {"value": worst, "limit": limit},
                     "frames_compared": {"value": len(readings),
                                         "limit": cell.check["sample_calls"]
                                         * run.batch}}
    return line


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name (the program's own name begins with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv: List[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="s3dbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0=t0)
    except NoCard as e:
        print(f"s3dbench: {e}", file=sys.stderr)
        return 2
    loaded = forbidden_modules()
    if loaded:
        print(f"s3dbench: JAX modules loaded in the run: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in out.line["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out.line))
    return 0
