"""Reduction of a `torch.profiler` Chrome trace to the benchmark's numbers.

The arithmetic is a copy of the port's `utils/profiling.py`
(`device_events`, `interval_union_ms`): device busy time is the union of
every kernel, memcpy and memset interval on all streams, never their sum.
Added here: the idle gaps of the device named by the host range that was
open while the device waited, and the top device operations, for the
result's `breakdown`.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "(outside any range)"


@contextlib.contextmanager
def device_trace(path: str):
    """Profile the block (host and card) and write the Chrome trace to
    @path. The card is synchronised at both ends, so the trace holds all
    the block's device work; a `bench:traced` range spans the block.
    Without a card only the host is traced."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("bench:traced"):
            yield prof
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def load(path: str) -> list[dict]:
    with open(path) as f:
        ev = json.load(f)
    return ev["traceEvents"] if isinstance(ev, dict) else ev


def slim(path: str) -> list[dict]:
    """The events of the trace at @path that the readers use (device work
    and the `stage:` / `bench:` host ranges), each with the fields they
    read. The raw trace of a NOF batch period holds millions of objects,
    whose upkeep would slow the host-bound window that follows."""
    keep = []
    for e in load(path):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS or name.startswith(("stage:", "bench:")):
            keep.append({"ph": "X", "cat": cat, "ts": e["ts"],
                         "dur": e.get("dur", 0.0), "name": name,
                         "args": {"stream": (e.get("args") or {}).get(
                             "stream", e.get("tid"))}})
    return keep


def _complete(events, cats):
    return [e for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() in cats]


def device_events(events) -> list[tuple]:
    """(start_us, end_us, name, stream) of every kernel, memcpy and memset."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             str(e.get("name", "")),
             (e.get("args") or {}).get("stream", e.get("tid")))
            for e in _complete(events, DEVICE_CATS)]


def merge(iv) -> list[tuple[float, float]]:
    """The union of intervals (start, end, ...) as sorted disjoint
    (start, end) pairs."""
    out: list[list[float]] = []
    for s, t in sorted((float(a), float(b)) for a, b, *_ in iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def union_us(iv) -> float:
    """Length of the union of intervals, in the intervals' unit."""
    return sum(t - s for s, t in merge(iv))


def window_us(events) -> tuple[float, float]:
    """(first, last) timestamp of the traced slice: the span of its host
    and device events."""
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") == "X" and "ts" in e:
            s = float(e["ts"])
            lo = min(lo, s)
            hi = max(hi, s + float(e.get("dur", 0.0)))
    return lo, hi


def busy_and_window_s(events) -> tuple[float, float]:
    """(device-busy seconds, traced wall seconds) of a trace."""
    lo, hi = window_us(events)
    return union_us(device_events(events)) / 1e6, (hi - lo) / 1e6


def top_ops(events, n: int = 10) -> list[list]:
    """The @n device operations that took most time, [name, seconds]."""
    by = collections.defaultdict(float)
    for s, t, name, _ in device_events(events):
        by[name] += t - s
    return [[k, v / 1e6] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def host_ranges(events, prefixes=("stage:", "bench:")) -> list[tuple]:
    """(start_us, end_us, name) of the host ranges whose name starts with
    one of @prefixes (the port's `stage:<name>` ranges, the benchmark's
    own `bench:<name>` ranges)."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             str(e["name"]))
            for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith(prefixes)]


def idle_gaps(events, n: int = 10) -> list[list]:
    """The @n longest spans in which the device ran nothing, each named by
    the innermost host range open at the gap's middle (or `OUTSIDE`),
    [name, seconds]. Gaps are counted between the first and the last
    device event."""
    busy = merge(device_events(events))
    ranges = sorted(host_ranges(events))
    starts = [r[0] for r in ranges]
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        inside = [r for r in ranges[:i] if r[1] >= mid]
        name = max(inside)[2] if inside else OUTSIDE
        gaps.append([name, (b - a) / 1e6])
    return sorted(gaps, key=lambda g: -g[1])[:n]


def kernel_us(events, match) -> tuple[float, int]:
    """(summed device microseconds, count) of the device events whose name
    satisfies @match."""
    ev = [(s, t) for s, t, name, _ in device_events(events) if match(name)]
    return sum(t - s for s, t in ev), len(ev)


def preceding_us(events, match, pred_match) -> float:
    """Summed microseconds of the device event that directly precedes, on
    the same stream, each event matching @match, where that event
    satisfies @pred_match (the zero fill of a kernel's output)."""
    by_stream = collections.defaultdict(list)
    for ev in device_events(events):
        by_stream[ev[3]].append(ev)
    total = 0.0
    for evs in by_stream.values():
        evs.sort()
        for prev, cur in zip(evs, evs[1:]):
            if match(cur[2]) and pred_match(prev[2]):
                total += prev[1] - prev[0]
    return total
