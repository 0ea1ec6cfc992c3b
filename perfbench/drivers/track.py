"""Pose-only tracking: `BundleSdf.run` over the orbit with the NOF off.

Set-up renders the orbit on the card and tracks `warmup_frames` frames,
then finishes the last one's bundle adjustment. The window times every
`run` call until `--seconds` have passed and closes after
`flush_pipeline()`, so the last frame's bundle adjustment, which `run`
pulls only at the next call, lies inside it. With `--trace 1`
`traced_frames` frames run under the profiler before the window opens. Once the
window has closed the frozen reference tracks the same frames from the
first, and each window frame's pose is compared.
"""
from __future__ import annotations

import gc
import os
import shutil
import time

import numpy as np
import torch

from perfbench import trace
from perfbench.drivers import common, tracking
from perfbench.harness import Outcome


def run(cell):
    dev = cell.device
    p = cell.traffic
    parts = common.Parts(cell.t_start)
    mod = tracking.program()
    parts.mark("imports")
    sc = tracking.frames(cell)
    parts.mark("render")
    tracker = tracking.make_tracker(mod, cell,
                                    os.path.join(cell.scratch, "out"))
    feed = tracking.Feed(tracker, sc)
    parts.mark("build")
    with torch.profiler.record_function("bench:warmup"):
        while feed.i < int(p["warmup_frames"]):
            feed.step()
        feed.flush()
    common.sync(dev)
    setup_s = parts.mark("warmup")
    cell.note(parts.line())

    events = None
    if cell.trace:
        # the traced frames run before the window, so the profiler's host
        # cost stays out of the window that the stage tables read
        n_tr = int(p["traced_frames"])
        path = os.path.join(cell.scratch, "trace", "trace.json")
        with trace.device_trace(path):
            for _ in range(n_tr):
                feed.step()
            feed.flush()
        events = trace.slim(path)
        gc.collect()
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)

    first = feed.i
    n_stage0 = len(tracker.stage_stats)
    times = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        feed.step()
        times.append(time.perf_counter() - t)
        if time.perf_counter() - t0 >= cell.seconds:
            break
    feed.flush()
    common.sync(dev)
    wall = time.perf_counter() - t0
    ids = list(range(first, feed.i))
    window = {"stages": tracker.stage_stats[n_stage0:], "frames": len(ids),
              "units": len(ids), "events": events, "window_s": wall,
              "nof_s": 0.0, "device_kind": common.device_kind(dev)}
    if events is not None:
        window["trace_units"] = int(p["traced_frames"])
    prog_poses = dict(feed.poses)
    failed = sum(feed.failed.get(i, True) for i in ids)
    peak = common.memory_peak(dev)
    n_fed = feed.i
    del feed, tracker
    common.release(dev)

    ref_poses = tracking.replay(cell, sc, n_fed, flush=True)
    compared = tracking.pose_comparison(cell, prog_poses, ref_poses, ids)
    if dev.startswith("cuda"):
        cell.note(f"card {common.device_label()}")
    cell.note(f"setup_s {setup_s!r} window_s {wall!r} frames {len(ids)} "
              f"failed {failed}")
    thirds = np.array_split(np.asarray(times), 3)
    cell.note("frames/s by thirds of the window: " + " ".join(
        f"{len(x) / max(float(x.sum()), 1e-9):.3f}" for x in thirds))
    out = Outcome(
        end_to_end={"frames_per_s": len(ids) / wall,
                    "frame_ms_p95": common.p95(times) * 1e3,
                    "setup_s": setup_s},
        window=window, compared=compared, attempted=len(ids), failed=failed,
        memory_peak_bytes=peak)
    if events is not None:
        out.busy_s, out.window_s = trace.busy_and_window_s(events)
        out.breakdown = {"device_ops": trace.top_ops(events),
                         "idle_gaps": trace.idle_gaps(events)}
    return out
