"""Profiling hooks: a torch.profiler trace of a region, named ranges in
it, and steady-state step timing.

The port's counterpart of `conductor_tpu/utils/profiling.py`: `trace`
records the enclosed region with `torch.profiler` (the host, and the card's
kernels where there is one) and writes a Chrome trace under ``log_dir``
(open it in Perfetto or ``chrome://tracing``); `annotate` names a range in
it (`torch.profiler.record_function`, and an NVTX range on CUDA, which
Nsight tools read); `StepTimer` times steps after a warm-up, each ended by
synchronizing the device its result lies on, with JAX's summary keys.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region; on exit write ``log_dir/trace_<k>.json``
    (the next free k).  Yields the `torch.profiler.profile`, whose
    ``trace_path`` is set on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    k = 0
    while os.path.exists(os.path.join(log_dir, f"trace_{k}.json")):
        k += 1
    prof.trace_path = os.path.join(log_dir, f"trace_{k}.json")
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """A named range inside an active trace (and an NVTX range on CUDA)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _synchronize(result) -> None:
    """Wait for every CUDA device holding a tensor of ``result`` (a tensor
    or nested lists, tuples and dicts of them)."""
    devices, todo = set(), [result]
    while todo:
        x = todo.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Steady-state step timing with the device synchronized.

    >>> timer = StepTimer(warmup=2)
    >>> for batch in data:
    ...     out = step(...)
    ...     timer.tick(out)          # waits for `out`, records elapsed
    >>> timer.summary()              # {'mean_s', 'p50_s', 'best_s', 'steps'}
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._seen = 0
        self._last = time.perf_counter()

    def tick(self, result=None) -> float:
        if result is not None:
            _synchronize(result)
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)
        return dt

    def summary(self) -> dict[str, float]:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "p50_s": ts[len(ts) // 2],
            "best_s": ts[0],
        }
