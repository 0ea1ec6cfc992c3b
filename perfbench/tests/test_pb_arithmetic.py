"""The trace arithmetic, the window's statistics and the yardstick's
counts, on synthetic inputs."""
import math
import statistics

import numpy as np
import pytest

from perfbench import harness, roofline, trace
from perfbench.drivers import common, online


def _ev(cat, ts, dur, name="k", stream=7, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name,
         "tid": tid, "pid": 1, "args": {"stream": stream}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 25), (24, 30), (40, 41)]
    assert trace.union_us(iv) == 15 + 10 + 1
    assert trace.merge(iv) == [(0, 15), (20, 30), (40, 41)]


def test_busy_idle_and_gaps():
    ev = [_ev("kernel", 100, 50, "a", stream=1),
          _ev("kernel", 120, 60, "b", stream=2),
          _ev("gpu_memset", 400, 100, "fill", stream=1),
          _ev("cpu_op", 0, 1000, "bench:train"),
          _ev("user_annotation", 200, 150, "stage:detect")]
    busy, span = trace.busy_and_window_s(ev)
    assert busy == pytest.approx(180e-6)
    assert span == pytest.approx(1000e-6)
    gaps = trace.idle_gaps(ev)
    assert gaps[0][0] == "stage:detect"
    assert gaps[0][1] == pytest.approx(220e-6)
    ops = trace.top_ops(ev)
    assert ops[0][0] == "fill" and ops[0][1] == pytest.approx(100e-6)


def test_kernel_and_its_fill():
    ev = [_ev("gpu_memset", 0, 5, "fill"),
          _ev("kernel", 6, 10, "void scatter_rows_kernel<float>"),
          _ev("kernel", 20, 3, "other"),
          _ev("kernel", 30, 4, "FillFunctor"),
          _ev("kernel", 40, 10, "void scatter_rows_kernel<float>")]
    k, n = trace.kernel_us(ev, lambda s: "scatter_rows" in s)
    assert (k, n) == (20, 2)
    fill = trace.preceding_us(ev, lambda s: "scatter_rows" in s,
                              lambda s: "fill" in s.lower())
    assert fill == 9


def test_p95_is_the_inclusive_quantile():
    v = list(range(1, 201))
    assert common.p95(v) == statistics.quantiles(v, n=100,
                                                 method="inclusive")[94]
    assert common.p95([3.0]) == 3.0


def test_pose_gaps():
    a = np.eye(4)
    b = np.eye(4)
    b[:3, 3] = [0.001, 0, 0]
    th = math.radians(2.0)
    b[:3, :3] = [[math.cos(th), -math.sin(th), 0],
                 [math.sin(th), math.cos(th), 0], [0, 0, 1]]
    t, r = common.pose_gaps({1: a}, {1: b}, [1])
    assert t == pytest.approx(1.0)
    assert r == pytest.approx(2.0)
    assert common.pose_gaps({1: a}, {1: a * (1 + 1e-9)}, [1])[1] < 1e-6
    assert common.pose_gaps({1: a}, {}, [1]) == (math.inf, math.inf)


def test_worst_leaf_gap_uses_the_median_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.0, "b": 2.2, "c": 3e-9}
    gap, which = common.worst_leaf_gap(prog, ref)
    assert which == "b" and gap == pytest.approx(0.1)
    gap, which = common.worst_leaf_gap({**prog, "b": 2.0}, ref)
    assert gap == pytest.approx(2e-9 / 1.0)


class _Nerf:
    def __init__(self, busy):
        self.training_in_flight = busy


class _Tracker:
    def __init__(self, n, busy=False):
        self.pipeline_stats = {"n_batches": n}
        self.nerf = _Nerf(busy)


def test_window_boundaries_are_batch_ends():
    assert online.batch_finished(_Tracker(1), 0)
    assert not online.batch_finished(_Tracker(1), 1)
    assert not online.batch_finished(_Tracker(2, busy=True), 1)
    assert online.nof_seconds({"nerf_prep_s": 1.0, "nerf_sync_s": 2.5,
                               "n_batches": 4}) == 3.5


@pytest.mark.parametrize("config,megabytes", [
    ("custom.online", 120.4), ("custom.refine", 987.9),
    ("ho3d.refine", 1075.7)])
def test_scatter_bytes_at_the_three_shapes(config, megabytes):
    name, which = config.split(".")
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    nerf = dict(cfg["nerf"])
    if which == "refine":
        nerf.update(cfg["refine"])
    assert round(roofline.scatter_bytes(nerf) / 1e6, 1) == megabytes
    assert roofline.scatter_bound_s(nerf) == pytest.approx(
        roofline.scatter_bytes(nerf) / roofline.HBM_BYTES_S)


def test_step_flops_count_every_sample():
    cfg = harness.load_json(f"{harness.HERE}/configs/custom.json")
    nerf = dict(cfg["nerf"], **cfg["refine"])
    s = roofline.step_shapes(nerf)
    assert s["samples"] == 64 + 256 and s["rows"] == 39601891
    per_point = 3 * (2 * (32 * 64 + 64 * 16)
                     + 2 * ((9 + 2 + 15) * 64 + 64 * 64 + 64 * 3)
                     + 2 * 8 * 2 * 16)
    assert roofline.nof_step_flops(nerf) == 2048 * 320 * per_point
