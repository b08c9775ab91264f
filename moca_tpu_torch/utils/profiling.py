"""Tracing and stage timing.

Port of moca_tpu/utils/profiling.py:
  * `trace(log_dir)`: torch.profiler over the CPU and the GPU, exported as a
    Chrome trace into `log_dir`;
  * `annotate(name)`: a named range in the trace of any torch.profiler that
    is recording, `trace()` included, and one shared no-op context (a single
    C query) when none is: the port's only span facility;
  * `StepTimer`: seconds per named stage and one `{"profile": ...}` JSON line
    when MOCA_TPU_PROFILE=1. The pipelines keep their stage seconds in one
    (`record`, which waits for the device's queued work first, inside a
    `timer.sync` range), so `pipe.timings` and the profile line read the
    same records.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch


@contextmanager
def trace(log_dir: str = "build/moca_tpu_trace"):
    """Profile the block (CPU ops, and GPU kernels where there is a GPU) and
    write `trace.json` (Chrome trace format) into log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = nullcontext()


def annotate(name: Optional[str]):
    """A named range in the trace, around host code that launches device work
    (none where `name` is None).

    `torch._C._autograd._profiler_enabled()` is the test, not the Python flag
    `torch.autograd.profiler._is_profiler_enabled`: a profiler started with
    `torch.autograd._enable_profiler` leaves the flag False. With no
    profiler recording, a span costs that one C query: a `record_function`
    would cost its set-up and an operator call even then."""
    if name is None or not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock seconds per named stage; prints one JSON line."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("MOCA_TPU_PROFILE", "0") == "1"
        self.enabled = enabled
        self.times: Dict[str, List[float]] = {}

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, t0: float, device: Optional[torch.device] = None,
               sync: bool = True) -> float:
        """Add the seconds since t0 to stage `name`, the device's queued work
        included unless `sync` is off, whether or not the timer is enabled;
        returns the time now."""
        if sync and device is not None and device.type == "cuda":
            with annotate("timer.sync"):
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.add(name, now - t0)
        return now

    def add(self, name: str, seconds: float):
        self.times.setdefault(name, []).append(seconds)

    def totals(self) -> Dict[str, float]:
        """Seconds per stage."""
        return {name: sum(ts) for name, ts in self.times.items()}

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {
                "count": len(ts),
                "total_s": round(sum(ts), 4),
                "mean_s": round(sum(ts) / len(ts), 4),
                "min_s": round(min(ts), 4),
            }
        return out

    def report(self):
        if self.enabled and self.times:
            print(json.dumps({"profile": self.summary()}))
