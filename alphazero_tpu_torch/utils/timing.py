"""Per-phase wall-clock timers, synchronised with the device, and a
profiler trace around a block.

Counterpart of ``alphazero_tpu/utils/timing.py``: where the JAX coach
blocks on a phase's arrays, the port's ``PhaseTimer`` calls
``synchronize`` on its tensors (``torch.cuda.synchronize`` for CUDA
tensors; CPU tensors are ready when they exist); where the JAX
``profiler_trace`` runs ``jax.profiler`` around a block, the port's runs
``torch.profiler`` and writes a chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace around a block; a no-op (yielding
    None) when ``log_dir`` is empty. The profile records CPU activity, and
    CUDA activity when the process has a card; on leaving the block it is
    written into ``log_dir`` as a chrome trace, ``trace_<pid>_<ns>.json``.
    Yields the ``torch.profiler.profile``, whose ``trace_path`` attribute
    names the file once the block is left."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(prof.trace_path)
