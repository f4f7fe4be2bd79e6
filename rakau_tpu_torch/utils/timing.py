"""Spans at the port's layer boundaries, on the profiler's clock.

`span(name)` opens `torch.profiler.record_function("rakau." + name)` while
a torch profiler is recording, and is one shared null context otherwise:
with no profiler it allocates nothing and reads no clock. The recording
profiler keeps the spans with its trace, on the clock of the device
operations it records, so each device operation can be put down to the
span that launched it. Spans nest on the host thread; the entry span (a
query, a step) gives a call its identity.

No span opens while the current stream is being captured into a CUDA
graph: a captured function's host code runs once, at capture, and never
at a replay.

`read(x, what)` is the one way the host path reads a device value: it
returns `x.cpu()`, under span `read.<what>`, so that the wait for the card
is named in a trace."""
from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.autograd.profiler as _profiler

PREFIX = "rakau."
_NULL = nullcontext()


def span(name: str):
    """A context manager: the span `rakau.<name>` while a profiler records
    (outside a CUDA graph capture), else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return _NULL
    return _profiler.record_function(PREFIX + name)


def read(x: torch.Tensor, what: str) -> torch.Tensor:
    """x on the host (x.cpu()), under span `read.<what>`."""
    with span("read." + what):
        return x.cpu()
