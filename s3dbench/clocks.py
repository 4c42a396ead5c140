"""The card's clocks in a window, read through NVML (``libnvidia-ml``).

The client calls ``Clocks.tick`` after every call; once a second it reads
the SM and memory clocks and the reasons NVML gives for holding them down
(``nvmlDeviceGetCurrentClocksEventReasons``), beside the frames and the host
time of the calls since the last reading. So a run's line says at what
clocks each second of its window ran and how fast. NVML's device 0 is read:
every cell runs on one card. Where the library is missing, nothing is read.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

SM, MEM = 1, 2                  # nvmlClockType_t


class Clocks:
    """Readings of the card's clocks, one every ``every`` seconds."""

    def __init__(self, every: float = 1.0) -> None:
        self.every, self.rows = every, []
        self.lib: Optional[ctypes.CDLL] = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        handle = ctypes.c_void_p()
        if lib.nvmlInit_v2() or lib.nvmlDeviceGetHandleByIndex_v2(
                0, ctypes.byref(handle)):
            return
        self.reasons = getattr(lib, "nvmlDeviceGetCurrentClocksEventReasons",
                               None) or lib.nvmlDeviceGetCurrentClocksThrottleReasons
        self.lib, self.handle = lib, handle

    def _clock(self, kind: int) -> int:
        mhz = ctypes.c_uint()
        self.lib.nvmlDeviceGetClockInfo(self.handle, kind, ctypes.byref(mhz))
        return mhz.value

    def start(self) -> None:
        """Open a window: the first reading comes ``every`` seconds on."""
        now = time.perf_counter()
        self.rows, self.last, self.due = [], (now, 0, 0.0), now + self.every

    def tick(self, now: float, calls: int, batch: int, entry_s: float) -> None:
        """After a call: read the clocks if a reading is due. ``calls`` and
        ``entry_s`` are the window's so far, ``batch`` frames a call."""
        if self.lib is None or now < self.due:
            return
        reasons = ctypes.c_ulonglong()
        self.reasons(self.handle, ctypes.byref(reasons))
        t, c, e = self.last
        n = calls - c
        self.rows.append([self._clock(SM), self._clock(MEM), reasons.value,
                          batch * n / (now - t),
                          (entry_s - e) / n * 1e6])
        self.last, self.due = (now, calls, entry_s), now + self.every

    def summary(self) -> Optional[dict]:
        """Each second's [SM MHz, memory MHz, reasons, frames/s, host µs a
        call], with the range of the clocks and every reason seen."""
        if not self.rows:
            return None
        sm = [r[0] for r in self.rows]
        mem = [r[1] for r in self.rows]
        seen = 0
        for r in self.rows:
            seen |= r[2]
        return {"sm_mhz": [min(sm), max(sm)], "mem_mhz": [min(mem), max(mem)],
                "reasons": hex(seen), "every_s": self.every,
                "columns": ["sm_mhz", "mem_mhz", "reasons", "frames_per_s",
                            "host_us_a_call"],
                "seconds": self.rows}
