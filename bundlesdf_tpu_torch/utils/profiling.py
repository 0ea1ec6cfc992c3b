"""Tracing / profiling utilities.

Port of `bundlesdf_tpu/utils/profiling.py`: named host spans that wait for
the device (`Timer`, the reference's `CUDATimer`,
BundleTrack/src/cuda/CUDATimer.h:1-121) and `torch.profiler` traces of the
card. The trace helpers that the JAX package's `bench.py` keeps at module
level (`bench.py:50-114`) live here, read from a `torch.profiler` Chrome
trace:

- `device_events`: every kernel, memcpy and memset of the trace, on every
  stream;
- `interval_union_ms`: the device-busy time of a set of intervals. Streams
  overlap (the NOF runner's stream runs beside the tracker's), so busy
  time is the union of the intervals, never their sum;
- `device_ms_by_range`: the device time of the kernels launched inside
  each `stage:<name>` range that `BundleSdf._stage` marks, and of those
  launched outside any.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import time

import torch

# Chrome-trace categories of device work in a torch.profiler (Kineto) trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side categories that launch device work; their `correlation` arg
# pairs each launch with its device event
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside any range)"


class Timer:
    """Named-span timer with aggregate reporting (CUDATimer equivalent).

    Usage:
        timer = Timer()
        with timer.span("ba"):
            ...device work...
        print(timer.report())

    With @sync, each span waits for @device's queued work at its start and
    end (`torch.cuda.synchronize`); on the CPU there is nothing to wait
    for."""

    def __init__(self, enabled: bool = True, sync: bool = True,
                 device=None):
        self.enabled = enabled
        self.sync = sync
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    def _barrier(self):
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._barrier()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._barrier()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["=== timer report ==="]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:30s} total {tot*1e3:9.1f}ms  "
                         f"calls {n:5d}  mean {tot/n*1e3:8.2f}ms")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Profile the block with `torch.profiler` (CPU activity, and the
    card's when @device is a CUDA device) and write the Chrome trace to
    `<log_dir>/trace.json`, viewable in Perfetto. Yields the profile
    object; a failure to trace propagates."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device("cpu") if device is None else torch.device(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = trace_path(log_dir)
    prof.export_chrome_trace(path)
    logging.info(f"profiler trace written to {path}")


def trace_path(log_dir: str) -> str:
    """Where `device_trace` writes the trace of @log_dir."""
    return os.path.join(log_dir, "trace.json")


def load_trace(path: str) -> list[dict]:
    """The event list of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)
    return events["traceEvents"] if isinstance(events, dict) else events


def _complete(events, cats):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat", "").lower() in cats]


def device_events(events) -> list[tuple]:
    """(start_us, end_us, name, stream) of every kernel, memcpy and memset
    in @events (a Chrome trace's event list), on all streams."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""), (e.get("args") or {}).get("stream",
                                                           e.get("tid")))
            for e in _complete(events, DEVICE_CATS)]


def interval_union_ms(iv) -> float:
    """Length in ms of the union of intervals (start_us, end_us, ...): the
    time the device was busy with any of them, counting overlaps once
    (`bench.py:65-80`)."""
    iv = sorted((float(s), float(t)) for s, t, *_ in iv)
    total = 0.0
    end = float("-inf")
    for s, t in iv:
        if s >= end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1e3


def device_ms_by_range(events, prefix: str = "stage:") -> dict:
    """Device ms of the kernels launched inside each host range named
    `<prefix><name>` (the innermost such range on the launching thread),
    the union of each range's device intervals; work launched outside any
    such range is under `OUTSIDE`. Device events are paired with their
    launches by the trace's `correlation` ids (`bench.py:91-114` sums the
    TPU trace's module spans instead)."""
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(prefix):
            ranges[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                 e["name"][len(prefix):]))
    launch_range = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        ts = float(e["ts"])
        inside = [r for r in ranges.get((e.get("pid"), e.get("tid")), ())
                  if r[0] <= ts <= r[1]]
        if inside:
            # innermost: the latest start
            launch_range[corr] = max(inside)[2]
    by_range = collections.defaultdict(list)
    for e in _complete(events, DEVICE_CATS):
        corr = (e.get("args") or {}).get("correlation")
        ts = float(e["ts"])
        by_range[launch_range.get(corr, OUTSIDE)].append(
            (ts, ts + float(e.get("dur", 0.0))))
    return {k: interval_union_ms(v) for k, v in by_range.items()}
