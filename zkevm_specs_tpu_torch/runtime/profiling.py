"""Profiling hooks: per-region counters, a device trace and named ranges.

Counterpart of ``zkevm_specs_tpu/runtime/profiling.py``.  ``KernelStats``
adds up the host seconds and the calls of each named region (the block
verifier's ``run_device`` times each group, the state check and each
circuit under the JAX labels).  Where the card is in use, ``timed`` also
records a pair of CUDA events around the region.  A pair is folded into
``device_times`` and dropped once its end event has completed (checked
without waiting, at each ``timed``), or in ``report()``, which waits for
the rest; so nothing inside a pass waits for the card, and a long-running
verifier holds only the pairs still in flight.
``device_trace`` is a ``torch.profiler`` trace of CPU and CUDA activity,
written as a Chrome trace; ``annotate`` names a range in it (and in an
NVTX timeline on the card).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Tuple

import torch


class KernelStats:
    """Host wall clock, calls and (on the card) device time per named
    region."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.device_times: Dict[str, float] = defaultdict(float)
        # (name, start, end) of the regions whose end event has not been
        # folded into device_times yet, oldest first
        self._pending: Deque[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = deque()

    @contextlib.contextmanager
    def timed(self, name: str, device=None):
        """Time the region under ``name``; where ``device`` is a CUDA
        device, a pair of events also brackets the work the region queues."""
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.calls[name] += 1
            if cuda:
                end.record()
                self._pending.append((name, start, end))
                self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Add the device seconds of the pending regions into
        ``device_times``, oldest first, and drop their events: every one
        where ``wait``, else those whose end event has completed (a query,
        which does not wait for the card)."""
        while self._pending:
            name, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.device_times[name] += start.elapsed_time(end) / 1e3
            self._pending.popleft()

    def reset(self) -> None:
        self.times.clear()
        self.calls.clear()
        self._pending.clear()
        self.device_times.clear()

    def report(self) -> str:
        """JSON rows ``{"kernel", "seconds", "calls"}``, the longest host
        time first: the JAX report's keys and order.  Here, and only here,
        the card is waited for: the device seconds of every region timed on
        it are then in ``device_times``."""
        self._fold(wait=True)
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        return json.dumps([{"kernel": k, "seconds": round(v, 4), "calls": self.calls[k]}
                           for k, v in rows])


STATS = KernelStats()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of CPU and (where present) CUDA activity
    around the region, exported as a Chrome trace
    ``<log_dir>/trace-<pid>.json``; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named range: ``torch.profiler.record_function`` (seen in
    ``device_trace``), inside an NVTX range on the card."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield
