"""Device operations by a program span on the host's clock, for work that
runs on more than one host thread.

A span's scope reaches only the kernels launched on the thread that opened
it; a CUDA backward launches on PyTorch's autograd worker thread.  The
program closes its ``miso.align.*`` phase spans after the synchronize that
ends the phase's work, and opens the next phase after it, so the device
operations that started while such a span was open are the phase's own,
whatever thread launched them.
"""
from __future__ import annotations

from typing import Callable, Optional


def within(tr, name: str) -> Optional[Callable]:
    """A pick of the trace's device operations that started inside an
    occurrence of span ``name``; None where the trace has no such span."""
    spans = [(a, b) for a, b, n in tr.host_ops if n == name]
    if not spans:
        return None
    return lambda o: any(a <= o.ts <= b for a, b in spans)
