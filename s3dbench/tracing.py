"""The profiler's trace of a traced window, reduced to what the per-layer
metrics and the result's ``breakdown`` read.

``device_trace`` is the benchmark's copy of the program's
``utils/profiling.device_trace``, cut to the card's activity: torch.profiler
over the block with CUDA activity only (no host operators or annotations,
which would stretch each call's host side), written as a Chrome trace.
``Trace`` reads that file back. The window lies between two marker kernels
that the benchmark launches around the traced calls (``mark``): from the end
of the first to the start of the last. The device's activity is every
kernel, copy and fill the profiler saw on the card inside it (a replayed
CUDA graph shows each of its kernels); the host's is the CUDA runtime and
driver calls the profiler saw. Each copy inside it also keeps the bytes it
moved (``copies``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
RASTER = re.compile(r"raster_(flat|segmented)")
MARKER = "spin_kernel"          # the kernel of ``torch.cuda._sleep``


class Incomplete(RuntimeError):
    """The trace lost a marker kernel: CUPTI dropped activity records."""


def mark() -> None:
    """Launch the marker kernel that opens or closes a traced window."""
    torch.cuda._sleep(100)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the card's activity in the block; write ``log_dir/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


class Trace:
    """The events of ``path`` between its first and last marker kernel."""

    def __init__(self, path: str) -> None:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        marks = sorted((e for e in events if e.get("cat") == "kernel"
                        and MARKER in e.get("name", "")),
                       key=lambda e: e["ts"])
        if len(marks) < 2:
            raise Incomplete(f"{len(marks)} marker kernel(s) in {path}")
        self.t0 = marks[0]["ts"] + marks[0]["dur"]
        self.t1 = marks[-1]["ts"]
        self.host = sorted(
            ((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") in HOST_CATS
             and e["ts"] + e["dur"] >= self.t0 and e["ts"] <= self.t1),
            key=lambda h: (h[0], -h[1]))
        self.device = [
            (max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1),
             e["name"], e["cat"])
            for e in events if e.get("cat") in DEVICE_CATS
            and MARKER not in e.get("name", "")
            and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.copies = [
            (max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1),
             e["name"], int(e.get("args", {}).get("bytes", 0)))
            for e in events if e.get("cat") == "gpu_memcpy"
            and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self, raster: bool) -> List[Tuple[float, float, str, str]]:
        """The kernels inside the window: the raster kernels, or all others."""
        return [d for d in self.device if d[3] == "kernel"
                and bool(RASTER.search(d[2])) == raster]

    def device_to_host(self) -> List[Tuple[float, float, str, int]]:
        """The copies from the card to the host inside the window: (start,
        end, name, bytes)."""
        return [c for c in self.copies if "DtoH" in c[2]]

    def busy(self) -> List[Tuple[float, float]]:
        return _merge([(a, b) for a, b, _, _ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time
        (a kernel's name cut to its first 200 characters)."""
        total: Dict[str, float] = collections.Counter()
        for a, b, name, _ in self.device:
            total[name[:200]] += (b - a) * 1e-6
        return [[n, s] for n, s in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[host activity, seconds]: the card's idle time inside the window
        summed by the innermost host event under each gap's midpoint."""
        edges = [self.t0] + [x for s in self.busy() for x in s] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        starts = [h[0] for h in self.host]
        total: Dict[str, float] = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            # Host events nest: the latest-starting one over mid is innermost.
            inner = next((h for h in reversed(self.host[max(0, i - 256):i])
                          if h[1] >= mid), None)
            total[inner[2] if inner else "no host event"] += (b - a) * 1e-6
        return [[n, s] for n, s in total.most_common(top)]
