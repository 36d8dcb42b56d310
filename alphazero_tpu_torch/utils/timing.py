"""Per-phase wall-clock timers, synchronised with the device.

Counterpart of ``alphazero_tpu/utils/timing.py``'s ``PhaseTimer``: where
the JAX coach blocks on a phase's arrays, the port's calls ``synchronize``
on its tensors (``torch.cuda.synchronize`` for CUDA tensors; CPU tensors
are ready when they exist). The JAX ``profiler_trace`` is not
ported (ROADMAP queue 1, "Tracing: `profiler_trace`").
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


def synchronize(out) -> None:
    """Wait for the CUDA work behind every tensor in ``out`` (a tensor or
    a nest of tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            synchronize(v)


class PhaseTimer:
    """Accumulates wall-clock per named phase. A phase that launches device
    work ends with ``synchronize`` on what it produced, inside its block,
    so that its time holds that work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def reset(self) -> Dict[str, float]:
        s = self.summary()
        self.totals.clear()
        return s
