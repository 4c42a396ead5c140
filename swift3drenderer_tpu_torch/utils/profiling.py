"""Tracing / profiling utilities (counterpart of
``swift3drenderer_tpu.utils.profiling``).

The reference's only instrumentation is the 1 Hz frame-budget printout
(reference main.swift:143-153, mirrored in utils/telemetry.py). Here:
``torch.profiler`` trace capture around render calls, exported as a Chrome
trace, and steady-state frame timing of a chain of frames with CUDA events
(``time.perf_counter`` on the CPU), net of the same chain's empty cost.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block (the CPU, and the card
    when CUDA is available) and write it to ``log_dir/trace.json`` (Chrome
    trace format: chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` gives per-op times."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def steady_state_frame_time(
    render_one: Callable,
    matrices: np.ndarray,
    *,
    trials: int = 3,
    checksum_stride: int = 64,
) -> float:
    """Best-of-``trials`` steady-state seconds per frame of ``render_one(m)
    -> (pixels, depth)`` (tensors, e.g. ``Renderer.render_device``) over the
    chain of ``len(matrices)`` poses.

    The chain is issued back to back with no synchronisation between frames;
    each frame's checksum (a strided sum of its pixels) is kept on the
    device so every frame stays live, and one synchronisation ends the
    chain. The same chain without the render (the checksum of the matrix
    alone: its pinned input copy, dispatch and synchronisation) is timed the
    same way and subtracted. The timer is a pair of CUDA events when the pixels are on
    the card, ``time.perf_counter`` otherwise. The first chain warms up
    (builds kernels, captures graphs) and is not timed.

    The JAX function chains the frames inside one jitted ``lax.scan``; torch
    has no counterpart, so the chain here is the host's loop of calls, and a
    captured ``Renderer`` frame is one graph replay a call.
    """
    mats = [np.asarray(m, np.float32) for m in matrices]

    def chain():
        return [render_one(m)[0][::checksum_stride, ::checksum_stride]
                .to(torch.int64).sum() for m in mats]

    def empty():
        # The matrix travels as a captured frame's input does
        # (``graphs.FrameGraphs.run``): a pinned staging copy, copied
        # without blocking the host.
        return [stage(m).to(device, non_blocking=True).sum() for m in mats]

    def timed(fn, cuda):
        fn()                                   # warm up
        best = float("inf")
        for _ in range(trials):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                sums = fn()
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                sums = fn()
                seconds = time.perf_counter() - t0
            float(torch.stack(sums).sum())     # every frame was computed
            best = min(best, seconds / len(mats))
        return best

    device = render_one(mats[0])[0].device
    cuda = device.type == "cuda"

    def stage(m):
        host = torch.from_numpy(m.reshape(-1))
        return host.pin_memory() if cuda else host
    return max(timed(chain, cuda) - timed(empty, cuda), 1e-9)
