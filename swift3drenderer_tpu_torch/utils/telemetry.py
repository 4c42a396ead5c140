"""Frame telemetry — parity with the reference's 1 Hz perf printout
(reference main.swift:31-39, 112-113, 142-153): loop count, percentage of the
1/60 s frame budget consumed by updateAndRender, and a session running average.
Extended with per-stage timers (the reference has none — SURVEY.md section 5).
Copy of ``swift3drenderer_tpu.utils.telemetry``."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, Optional


class FrameStats:
    """Accumulates per-frame render time and prints the reference's 1 Hz report."""

    def __init__(self, frame_target: float = 1.0 / 60.0,
                 report_interval: float = 1.0,
                 printer: Optional[Callable[[str], None]] = print) -> None:
        self.frame_target = frame_target
        self.report_interval = report_interval
        self.printer = printer
        self.loop_nr = 0
        self.total_time = 0.0
        self.total_percentage = 0.0
        self.nr_of_sessions = 0
        self.last_report = time.monotonic()
        self.stage_time: Dict[str, float] = defaultdict(float)
        self.reports: list = []

    def add_frame(self, render_seconds: float, **stages: float) -> None:
        self.loop_nr += 1
        self.total_time += render_seconds
        for k, v in stages.items():
            self.stage_time[k] += v
        now = time.monotonic()
        if now > self.last_report + self.report_interval:
            self.last_report += self.report_interval
            self._report()

    def _report(self) -> None:
        if self.loop_nr == 0:
            return
        percentage = 100.0 * self.total_time / (self.frame_target * self.loop_nr)
        self.nr_of_sessions += 1
        self.total_percentage += percentage
        avg = self.total_percentage / self.nr_of_sessions
        lines = [f"# loops: {self.loop_nr}",
                 f"{percentage:.2f}%",
                 f"average: {avg:.2f}%"]
        if self.stage_time:
            per = {k: 1e3 * v / self.loop_nr for k, v in self.stage_time.items()}
            lines.append("stages: " + "  ".join(
                f"{k}={ms:.2f}ms" for k, ms in sorted(per.items())))
        self.reports.append({"loops": self.loop_nr, "percentage": percentage,
                             "average": avg})
        if self.printer:
            for line in lines:
                self.printer(line)
        self.total_time = 0.0
        self.loop_nr = 0
        self.stage_time.clear()


class StageTimer:
    """Context-manager stopwatch for per-stage times fed into FrameStats."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    class _Scope:
        def __init__(self, parent, name):
            self.parent, self.name = parent, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            self.parent.times[self.name] = (
                self.parent.times.get(self.name, 0.0)
                + time.perf_counter() - self.t0)

    def scope(self, name: str) -> "_Scope":
        return self._Scope(self, name)
