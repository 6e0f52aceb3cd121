"""What a runner gets for one run of one cell."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

from benchmark.tracing import Tracer

_IMPORTED = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (from /proc; since this module
    was imported where there is none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


@dataclass
class Context:
    workload: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    device: object
    tracer: Tracer = field(default_factory=lambda: Tracer(False))
    side: str = "program"  # or "control": the reference one precision lower in its place
    fault: Optional[str] = None  # a fault planted under the timed path (tests, control runs)
    setup_s: Optional[float] = None
    marks: list = field(default_factory=list)  # (what, process age) through set-up

    def mark(self, what: str) -> None:
        self.marks.append((what, process_age_s()))

    def window_started(self) -> None:
        """Called as the measured window opens: set-up ends here."""
        self.setup_s = process_age_s()
        self.tracer.window_open()

    def window_closed(self) -> None:
        self.tracer.window_close()

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
