"""What the metric files under ``metrics/`` compute, from a ``harness.Run``.

A per-layer reader returns None where the run has nothing to read (no trace,
no raster kernel in it, a card the peak table does not hold); the harness
then leaves the metric out of the line.
"""

from __future__ import annotations

from typing import Optional

from . import roofline


def frame_ms(run) -> float:
    return run.window.seconds / run.window.frames * 1e3


def frames_per_s(run) -> float:
    return run.window.frames / run.window.seconds


def setup_s(run) -> float:
    return run.setup_s


def entry_host_us(run) -> Optional[float]:
    """Host microseconds a call spends inside the program, entry to return,
    before any wait: the mean over the window's calls."""
    if run.trace is None:
        return None
    return run.window.entry_s / run.window.calls * 1e6


def _kernels(run, raster: bool):
    """The traced window's raster kernels, or all its other kernels; None
    where the card ran none of them (or the run was not traced)."""
    if run.trace is None or not run.traced_frames:
        return None
    return run.trace.kernels(raster) or None


def frontend_device_us(run) -> Optional[float]:
    """Device microseconds a frame of every kernel but the raster kernels."""
    k = _kernels(run, False)
    return None if k is None else sum(b - a for a, b, _, _ in k) / run.traced_frames


def frontend_kernels(run) -> Optional[float]:
    """Launches a frame of every kernel but the raster kernels."""
    k = _kernels(run, False)
    return None if k is None else len(k) / run.traced_frames


def kernel_device_us(run) -> Optional[float]:
    """Device microseconds a frame of the raster kernels."""
    k = _kernels(run, True)
    return None if k is None else sum(b - a for a, b, _, _ in k) / run.traced_frames


def kernel_roofline(run) -> Optional[float]:
    """The raster launches' least time over their measured time, in %."""
    k = _kernels(run, True)
    if k is None or run.card is None or not run.launches:
        return None
    measured = sum(b - a for a, b, _, _ in k) * 1e-6
    least = sum(roofline.least_seconds(nb, ops, run.card)
                for nb, ops in run.launches)
    return 100.0 * least / measured


def idle_share(run) -> Optional[float]:
    """The share of the traced window in which nothing ran on the card, in
    %: 1 - (the union of its device activity) / (its length), both from the
    one trace (``device.busy_s`` and ``window_s`` of the line)."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def _device_to_host(run):
    """The traced window's copies from the card to the host; None where it
    has none (or the run was not traced)."""
    if run.trace is None or not run.traced_frames:
        return None
    return run.trace.device_to_host() or None


def readback_device_us(run) -> Optional[float]:
    """Device microseconds a frame of the copies from the card to the host."""
    c = _device_to_host(run)
    return None if c is None else sum(b - a for a, b, _, _ in c) / run.traced_frames


def readback_bytes(run) -> Optional[float]:
    """Bytes a frame copied from the card to the host."""
    c = _device_to_host(run)
    return None if c is None else sum(n for _, _, _, n in c) / run.traced_frames
