"""Tracing / profiling utilities.

The program's spans and counters: `span(name)` times a block on the host
clock (`spanned(name)` each call of a function) and `count(name, n)` adds
to a counter, both into one process-wide registry that `snapshot()`
reads, `{name: (count, seconds)}` summed over threads. A span never waits
for the device; while a `torch.profiler` records, it also marks the block
as the host range `stage:<name>`, which lies on the trace's clock beside
the kernels the block launches. With no profiler recording no range is
entered at all.

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
  each `stage:<name>` range that `span` marks, and of those launched
  outside any.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import logging
import os
import threading
import time

import torch

# -- the registry of spans and counters ---------------------------------------
# One {name: (count, seconds)} table per thread, so threads never write one
# key; `snapshot` sums them. Tables of finished threads are folded into
# `_retired`.
_local = threading.local()
_lock = threading.Lock()
_now = time.perf_counter
_recording = torch.autograd._profiler_enabled
_tables: list[tuple[threading.Thread, dict]] = []
_retired: dict = {}


def _table() -> dict:
    table = getattr(_local, "table", None)
    if table is None:
        table = _local.table = {}
        with _lock:
            _tables.append((threading.current_thread(), table))
    return table


class span:
    """`with span(name) as s:` adds one to @name's count and the block's
    perf_counter seconds (also `s.seconds`) to its seconds, on the calling
    thread's table. Spans nest; each counts its own block. While a
    profiler records, the block is the host range `stage:<name>`."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _recording():
            self._range = torch.profiler.record_function("stage:"
                                                         + self.name)
            self._range.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        self.seconds = _now() - self._t0
        table = _table()
        n, s = table.get(self.name, (0, 0.0))
        table[self.name] = (n + 1, s + self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def spanned(name: str):
    """Decorator: each call of the function is the span @name."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Add @n to the counter @name (its seconds stay 0)."""
    table = _table()
    c, s = table.get(name, (0, 0.0))
    table[name] = (c + n, s)


def _add_into(into: dict, table: dict):
    for k, (n, s) in list(table.items()):
        n0, s0 = into.get(k, (0, 0.0))
        into[k] = (n0 + n, s0 + s)


def snapshot() -> dict:
    """A copy of the registry: {name: (count, seconds)}, summed over every
    thread that has recorded, finished threads included."""
    with _lock:
        live = []
        for thread, table in _tables:
            if thread.is_alive():
                live.append((thread, table))
            else:  # it writes no more: fold it in once
                _add_into(_retired, table)
        _tables[:] = live
        out = dict(_retired)
        for _, table in live:
            _add_into(out, table)
    return out


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


class _Ranges:
    """Host ranges (start, end, name) sorted by start, for the innermost
    one open at a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]
        # the latest end among the ranges up to each index: the scan back
        # stops where no earlier range is still open
        self.reach = []
        end = float("-inf")
        for r in self.ranges:
            end = max(end, r[1])
            self.reach.append(end)

    def innermost(self, ts):
        """The name of the open range with the latest start at @ts (the
        largest open one in (start, end, name) order), or None."""
        for i in range(bisect.bisect_right(self.starts, ts) - 1, -1, -1):
            if self.reach[i] < ts:
                return None
            if self.ranges[i][1] >= ts:
                return self.ranges[i][2]
        return None


def device_ms_by_range(events, prefix: str = "stage:") -> dict:
    """Device ms of the kernels launched inside each host range named
    `<prefix><name>`, the union of each range's device intervals; work
    launched outside any such range is under `OUTSIDE`. A launch belongs to
    the innermost such range open on the launching thread; a launch from a
    thread with none open (autograd's device threads, which launch the
    backward's kernels) to the innermost one open in the process at that
    moment. Device events are paired with their launches by the trace's
    `correlation` ids (`bench.py:91-114` sums the TPU trace's module spans
    instead)."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(prefix):
            by_thread[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                 e["name"][len(prefix):]))
    threads = {k: _Ranges(v) for k, v in by_thread.items()}
    by_pid = collections.defaultdict(list)
    for (pid, _), v in by_thread.items():
        by_pid[pid].extend(v)
    procs = {k: _Ranges(v) for k, v in by_pid.items()}
    launch_range = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        ts = float(e["ts"])
        own = threads.get((e.get("pid"), e.get("tid")))
        name = own.innermost(ts) if own is not None else None
        if name is None and e.get("pid") in procs:
            name = procs[e.get("pid")].innermost(ts)
        if name is not None:
            launch_range[corr] = name
    by_range = collections.defaultdict(list)
    for e in _complete(events, DEVICE_CATS):
        corr = (e.get("args") or {}).get("correlation")
        ts = float(e["ts"])
        by_range[launch_range.get(corr, OUTSIDE)].append(
            (ts, ts + float(e.get("dur", 0.0))))
    return {k: interval_union_ms(v) for k, v in by_range.items()}
