"""Phase timing: wall time per named phase, collected into a registry
and printed when enabled (RAKAU_TPU_TIMING=1 or `enable(True)`).

CUDA work is asynchronous, so a phase measures enqueue time unless the
code inside it waits for the device; the Tree's build and query phases
do (each reads its overflow flags on the host)."""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_enabled = os.environ.get("RAKAU_TPU_TIMING", "") not in ("", "0")
_records = defaultdict(list)


def enable(on: bool = True):
    global _enabled
    _enabled = on


def records():
    return {k: list(v) for k, v in _records.items()}


def reset():
    _records.clear()


@contextmanager
def phase_timer(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _records[name].append(dt)
        print(f"[rakau_tpu_torch] {name}: {dt * 1e3:.3f} ms", flush=True)
