"""Structured per-frame metrics + stage timing.

Replaces the reference's print()-based tracing (SURVEY.md §5
"Metrics / logging": main.py:73,101,143-146 etc.) with a JSONL metrics
stream and wall-clock stage timers, plus optional jax.profiler capture.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, every: int = 1,
                 stream=None):
        self.path = path
        self.every = max(every, 1)
        self._fh = open(path, "a") if path else None
        self.stream = stream
        self._n = 0

    def log(self, **fields):
        self._n += 1
        if self._n % self.every:
            return
        rec = {"t": time.time(), **fields}
        line = json.dumps(rec, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stream:
            print(line, file=self.stream)

    def close(self):
        if self._fh:
            self._fh.close()


class StageTimers:
    """Accumulating wall-clock timers, ns resolution, context-manager API:

        with timers.stage("frontend"): ...
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """jax.profiler capture when a logdir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_device() -> dict:
    """The device as JAX reports it, and the card's name and power limit
    as nvidia-smi gives them (a child process that does not import JAX).
    Exits the process when JAX's default device is not a GPU: a run that
    measures or checks the card must not fall back to the CPU."""
    import subprocess

    import jax
    devs = jax.devices()
    d0 = devs[0]
    print(f"device: platform={d0.platform} kind={d0.device_kind} "
          f"count={len(devs)}", flush=True)
    if d0.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {d0.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)                  # as nvidia-smi gives it
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs), "card": card}
