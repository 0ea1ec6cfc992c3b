"""The port's `utils/profiling.py`: the device-busy union against the JAX
bench's `_interval_union_ms` (the top-level `bench.py`), the trace reader
on a hand-made two-stream Chrome trace, the per-range attribution, the
`Timer` report against the JAX package's, and a CPU `device_trace`.

Tolerances: the union is the same float arithmetic in the same order as
`bench.py`'s, so it is held equal to within 1e-12 relative; the hand-made
trace's values are exact in binary, so they are held exactly."""
import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from bundlesdf_tpu.utils.profiling import Timer as JaxTimer
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
        # another thread: the stage ranges of tid 10 do not hold it
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
    got = device_ms_by_range(two_stream_trace())
    assert got == {"detect": 0.05, "inner": 0.02, "ba_dispatch": 0.1,
                   OUTSIDE: 0.038}


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
