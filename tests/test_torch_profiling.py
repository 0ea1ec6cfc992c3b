"""The port's `utils/profiling.py`: the device-busy union against the JAX
bench's `_interval_union_ms` (the top-level `bench.py`), the trace reader
on a hand-made two-stream Chrome trace, the per-range attribution, the
`Timer` report against the JAX package's, a CPU `device_trace`, and the
registry of spans and counters (nesting, threads, no profiler range while
no profiler records, the NOF step's ranges in a CPU trace).

Tolerances: the union is the same float arithmetic in the same order as
`bench.py`'s, so it is held equal to within 1e-12 relative; the hand-made
trace's values are exact in binary, so they are held exactly."""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bench as jax_bench
from nof_tiny import tiny_runner
from bundlesdf_tpu.utils.profiling import Timer as JaxTimer
from bundlesdf_tpu_torch.utils import profiling
from bundlesdf_tpu_torch.utils.profiling import (OUTSIDE, Timer,
                                                 device_events,
                                                 device_ms_by_range,
                                                 device_trace,
                                                 interval_union_ms,
                                                 load_trace, trace_path)


@pytest.mark.parametrize("seed", range(5))
def test_interval_union_equals_bench(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    start = rng.uniform(0, 1e4, n)
    dur = rng.exponential(50.0, n) * (rng.random(n) > 0.05)   # some empty
    iv = [(float(s), float(s + d), f"k{i}") for i, (s, d)
          in enumerate(zip(start, dur))]
    want = jax_bench._interval_union_ms(iv)
    assert interval_union_ms(iv) == pytest.approx(want, rel=1e-12)
    # never more than the sum, never less than the longest interval
    assert interval_union_ms(iv) <= dur.sum() / 1e3 + 1e-12
    assert interval_union_ms(iv) >= dur.max() / 1e3 - 1e-12


def _x(name, cat, ts, dur, pid, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def two_stream_trace():
    """A host thread (pid 1, tid 10) with two stage ranges, one nested
    range and launches in and out of them, a second host thread (tid 11),
    and the card's work on streams 7 and 8 (pid 0), overlapping."""
    host = [
        _x("stage:detect", "user_annotation", 0.0, 100.0, 1, 10),
        _x("stage:ba_dispatch", "user_annotation", 100.0, 100.0, 1, 10),
        _x("stage:inner", "user_annotation", 40.0, 20.0, 1, 10),
        _x("aten::mul", "cpu_op", 5.0, 3.0, 1, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 10.0, 2.0, 1, 10,
           correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 50.0, 2.0, 1, 10,
           correlation=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 150.0, 2.0, 1, 10,
           correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 250.0, 2.0, 1, 10,
           correlation=4),
        # another thread with no range open (as autograd's device thread):
        # the innermost range open in the process holds it
        _x("cudaMemsetAsync", "cuda_runtime", 20.0, 2.0, 1, 11,
           correlation=5),
    ]
    device = [
        _x("k_a", "kernel", 100.0, 50.0, 0, 7, correlation=1, stream=7),
        _x("k_inner", "kernel", 140.0, 20.0, 0, 7, correlation=2, stream=7),
        _x("Memcpy HtoD", "gpu_memcpy", 200.0, 100.0, 0, 8, correlation=3,
           stream=8),
        _x("k_late", "kernel", 290.0, 30.0, 0, 7, correlation=4, stream=7),
        _x("Memset", "gpu_memset", 400.0, 8.0, 0, 8, correlation=5,
           stream=8),
        # not device work: a range Kineto mirrors onto the card's timeline
        _x("stage:detect", "gpu_user_annotation", 100.0, 300.0, 0, 7),
    ]
    meta = [{"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "GPU 0"}}]
    return meta + host + device


def test_device_events_all_streams():
    ev = device_events(two_stream_trace())
    assert sorted((s, t, n, st) for s, t, n, st in ev) == [
        (100.0, 150.0, "k_a", 7), (140.0, 160.0, "k_inner", 7),
        (200.0, 300.0, "Memcpy HtoD", 8), (290.0, 320.0, "k_late", 7),
        (400.0, 408.0, "Memset", 8)]


def test_device_busy_is_the_union():
    # [100, 160] + [200, 320] + [400, 408]: 188 us, where the sum of the
    # five intervals is 208 us
    assert interval_union_ms(device_events(two_stream_trace())) == 0.188
    assert sum(t - s for s, t, *_ in device_events(two_stream_trace())) \
        == 208.0


def test_device_ms_by_range():
    # detect: k_a [100, 150] and, launched from tid 11 while detect was
    # open on tid 10, the memset [400, 408]
    got = device_ms_by_range(two_stream_trace())
    assert got == {"detect": 0.058, "inner": 0.02, "ba_dispatch": 0.1,
                   OUTSIDE: 0.03}


def test_launch_off_every_range_thread():
    """A launch on a thread with a range open of its own belongs to it; a
    launch on a thread with none open belongs to the innermost range open
    in the process (by latest start, across threads); with none open in
    the process it is outside."""
    host = [
        _x("stage:nof.step", "user_annotation", 0.0, 100.0, 1, 10),
        _x("stage:nof.backward", "user_annotation", 40.0, 30.0, 1, 10),
        _x("stage:nof.poll", "user_annotation", 0.0, 200.0, 1, 12),
        _x("stage:worker", "user_annotation", 45.0, 10.0, 1, 13),
        # autograd's device thread: no stage range of its own
        _x("cudaLaunchKernel", "cuda_runtime", 50.0, 1.0, 1, 11,
           correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 60.0, 1.0, 1, 11,
           correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 300.0, 1.0, 1, 11,
           correlation=3),
        # tid 12's own range holds its launch, though nof.step is inner
        _x("cudaLaunchKernel", "cuda_runtime", 20.0, 1.0, 1, 12,
           correlation=4),
    ]
    device = [_x("k1", "kernel", 100.0, 4.0, 0, 7, correlation=1, stream=7),
              _x("k2", "kernel", 110.0, 2.0, 0, 7, correlation=2, stream=7),
              _x("k3", "kernel", 400.0, 1.0, 0, 7, correlation=3, stream=7),
              _x("k4", "kernel", 120.0, 8.0, 0, 7, correlation=4, stream=7)]
    assert device_ms_by_range(host + device) == {
        "worker": 0.004, "nof.backward": 0.002, OUTSIDE: 0.001,
        "nof.poll": 0.008}


def test_timer_report_matches_jax():
    ours, ref = Timer(), JaxTimer()
    for t in (ours, ref):
        t.totals.update({"ba": 0.5, "match": 0.125})
        t.counts.update({"ba": 4, "match": 2})
    assert ours.report() == ref.report()
    ours.reset()
    with ours.span("x"):
        pass
    assert ours.counts == {"x": 1} and ours.totals["x"] >= 0.0


def test_device_trace_on_the_cpu(tmp_path):
    """On the CPU the trace holds host events only: no device timeline."""
    with device_trace(str(tmp_path)):
        with torch.profiler.record_function("stage:cpu_work"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = load_trace(trace_path(str(tmp_path)))
    assert any(e.get("name") == "stage:cpu_work" for e in events)
    assert device_events(events) == []
    assert device_ms_by_range(events) == {}
    with open(trace_path(str(tmp_path))) as f:
        assert "traceEvents" in json.load(f)


# -- the registry of spans and counters ---------------------------------------

def _since(before, name):
    n0, s0 = before.get(name, (0, 0.0))
    n1, s1 = profiling.snapshot().get(name, (0, 0.0))
    return n1 - n0, s1 - s0


def test_spans_nest_and_count():
    before = profiling.snapshot()
    with profiling.span("t.outer") as outer:
        for _ in range(3):
            with profiling.span("t.inner") as inner:
                time.sleep(0.002)
            assert inner.seconds >= 0.002
    profiling.count("t.launches")
    profiling.count("t.launches", 4)
    n, s = _since(before, "t.outer")
    assert n == 1 and s == pytest.approx(outer.seconds, rel=1e-9)
    n_in, s_in = _since(before, "t.inner")
    assert n_in == 3 and 0.006 <= s_in <= outer.seconds
    assert _since(before, "t.launches") == (5, 0.0)
    # a snapshot is a copy
    snap = profiling.snapshot()
    snap["t.outer"] = (0, 0.0)
    assert profiling.snapshot()["t.outer"] != (0, 0.0)


def test_span_counts_a_block_that_raises():
    before = profiling.snapshot()
    with pytest.raises(ValueError):
        with profiling.span("t.raises"):
            raise ValueError("x")
    assert _since(before, "t.raises")[0] == 1


def test_spanned_function():
    @profiling.spanned("t.fn")
    def fn(x, y=1):
        """doc"""
        return x + y
    before = profiling.snapshot()
    assert fn(2, y=3) == 5 and fn(1) == 2
    assert fn.__doc__ == "doc" and fn.__wrapped__(1) == 2
    assert _since(before, "t.fn")[0] == 2


def test_threads_sum_into_one_snapshot():
    """More threads than cores write the same names at once, with the
    interpreter switching threads as often as it can, while snapshots are
    taken; every span and count arrives, also from threads that have
    finished."""
    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 500
    before = profiling.snapshot()
    go = threading.Barrier(n_threads + 1)

    def work():
        go.wait(timeout=60)
        for _ in range(n):
            with profiling.span("t.shared"):
                pass
            profiling.count("t.shared_count", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        go.wait(timeout=60)
        while any(t.is_alive() for t in threads):
            assert _since(before, "t.shared")[0] <= n_threads * n
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _since(before, "t.shared")[0] == n_threads * n
    assert _since(before, "t.shared_count") == (2 * n_threads * n, 0.0)
    # folded once: a second snapshot reads the same
    assert _since(before, "t.shared")[0] == n_threads * n


def test_no_profiler_range_while_no_profiler_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def recording(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with profiling.span("t.quiet"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("t.loud"):
            pass
    assert entered == ["stage:t.loud"]
    with profiling.span("t.quiet"):
        pass
    assert entered == ["stage:t.loud"]


def test_nof_step_ranges_in_a_cpu_trace(tmp_path):
    """Two NOF steps of a tiny runner under `device_trace`: each step's
    `stage:nof.*` ranges lie in the trace, the inner ones within their
    step."""
    runner = tiny_runner()
    with device_trace(str(tmp_path)):
        runner.train(n_steps=2)
    events = load_trace(trace_path(str(tmp_path)))
    ranges = [e for e in events if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("stage:")]
    names = [e["name"] for e in ranges]
    for k in ("render", "loss", "backward", "adam", "step"):
        assert names.count(f"stage:nof.{k}") == 2, k
    assert names.count("stage:nof.pull") == 1
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
             if e["name"] == "stage:nof.step"]
    for e in ranges:
        if e["name"] in ("stage:nof.render", "stage:nof.adam"):
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in steps)


def test_build_span_only_when_it_compiles(tmp_path):
    """`build.<stem>` times the compiler's run; a build found in place
    records none."""
    from bundlesdf_tpu_torch.utils import jpeg
    before = profiling.snapshot()
    jpeg.build_library(str(tmp_path / "b"))
    n, s = _since(before, "build.jpeg_decode")
    assert n == 1 and s > 0.0
    mid = profiling.snapshot()
    jpeg.build_library(str(tmp_path / "b"))
    assert _since(mid, "build.jpeg_decode") == (0, 0.0)


def test_host_pull_names_its_site():
    """A pull names its site; on the CPU nothing is waited for, so no
    `pull.<site>` span is recorded (on the card see test_torch_cuda.py)."""
    from bundlesdf_tpu_torch.utils.transfer import HostPull
    with pytest.raises(TypeError):
        HostPull({"x": torch.ones(2)})
    before = profiling.snapshot()
    got = HostPull({"x": torch.arange(3)}, "track.test").get()
    assert got["x"].tolist() == [0, 1, 2]
    assert _since(before, "pull.track.test") == (0, 0.0)
