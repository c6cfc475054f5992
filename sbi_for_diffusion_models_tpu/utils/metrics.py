"""Structured metrics + profiling harness.

The reference's only observability is stdout prints (reference:
data_simulator.py:56-57,102-111; mnle.py:218) and a gitignored TensorBoard dir
from sbi's internal writer. This module is the framework's metrics tier:

* ``MetricsLogger`` — append-only JSONL event log (stage, name, value, time);
* ``timed`` — wall-clock a device computation, waiting for it with
  ``jax.block_until_ready``;
* ``trace`` — context manager around ``jax.profiler`` for on-demand device
  traces.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable

import jax

__all__ = ["MetricsLogger", "timed", "trace"]


class MetricsLogger:
    """Append-only JSONL metrics: one {"ts", "stage", "name", "value"} per line."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, stage: str, name: str, value: Any, **extra) -> None:
        rec = {"ts": time.time(), "stage": stage, "name": name, "value": value}
        rec.update(extra)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        else:
            print(f"[metrics] {stage}/{name} = {value}")


def timed(fn: Callable, *args, sync: bool = True, **kwargs):
    """Run fn(*args, **kwargs), return (result, seconds); with ``sync`` the
    clock stops after the device has finished the result."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        jax.block_until_ready(out)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a jax.profiler trace around the enclosed block."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
