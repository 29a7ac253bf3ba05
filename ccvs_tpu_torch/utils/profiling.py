"""Profiling hooks (counterpart of ``ccvs_tpu/utils/profiling.py``):
``torch.profiler`` trace capture around training or generation steps, named
step regions, a completion barrier and a step-rate timer.

The reference has no profiler integration (unprinted ``time.time()`` probes
only). A trace written by :func:`trace` is a Chrome trace
(``chrome://tracing`` or Perfetto), one file a capture.
"""

import contextlib
import os
import time
from typing import Optional

import torch


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    if isinstance(x, torch.nn.Module):
        return next(iter(x.parameters()), None)
    return None


def device_sync(x=None):
    """Wait for the work queued on the device of ``x`` (a tensor, a module,
    or a dict / list holding one); the current CUDA device when ``x`` holds
    none. Nothing to wait for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    elif t is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_trace():
    """A started ``torch.profiler`` capture of the CPU and (where there is
    one) the CUDA activity; end it with :func:`stop_trace`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str, name: str = "trace") -> str:
    """Wait for the device, stop ``prof`` and export its Chrome trace to
    ``log_dir/<name>.json`` (returned)."""
    device_sync()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = "trace"):
    """Capture a ``torch.profiler`` trace of the block into the Chrome trace
    ``log_dir/<name>.json``; a no-op when ``log_dir`` is None. Yields the
    profiler (``key_averages()`` for a table), or None."""
    if not log_dir:
        yield None
        return
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, name)


def step_annotation(name: str, step: int):
    """Named step region ``name#step`` for the trace viewer."""
    return torch.profiler.record_function(f"{name}#{step}")


class Timer:
    """Wall-clock step timer with a device barrier; steps/sec."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self._t0 = time.perf_counter()
        self._n = 0

    def tick(self, result=None) -> Optional[float]:
        """Returns steps/sec every ``sync_every`` calls (else None), after
        waiting for the device work of ``result``."""
        self._n += 1
        if self._n % self.sync_every:
            return None
        if result is not None:
            device_sync(result)
        dt = time.perf_counter() - self._t0
        rate = self.sync_every / dt
        self._t0 = time.perf_counter()
        return rate
