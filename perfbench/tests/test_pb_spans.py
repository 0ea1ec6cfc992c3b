"""The readers of the program's spans on synthetic traced slices, and tiny
traced runs on the CPU that report the span metrics, with and without a
program whose spans mark ranges in the trace."""
import pytest

from bundlesdf_tpu_torch.utils import profiling
from perfbench import harness, spans
from perfbench.tests import tiny

SPAN_METRICS = ("nof_step.host_ms.refine", "nof_step.host_ms.online",
                "nof_runner.prep_ms.online", "tracker.pull_wait_ms")


def _read(name, window):
    return harness.load_metric(harness.HERE, name)(window)


def _ev(name, ms, cat="user_annotation", ts=0.0):
    """One complete event of a slimmed trace, @ms long."""
    return {"ph": "X", "cat": cat, "ts": ts, "dur": ms * 1e3, "name": name,
            "args": {"stream": 1}}


def test_ranges_are_the_host_stage_ranges():
    ev = [_ev("stage:nof.step", 30.0), _ev("stage:nof.step", 10.0),
          _ev("stage:nof.step", 99.0, cat="gpu_user_annotation"),
          _ev("stage:nof.step", 5.0, cat="kernel"),
          _ev("bench:train", 50.0), _ev("stage:nof.render", 7.0)]
    assert spans.ranges(ev, lambda n: n == "nof.step") == \
        pytest.approx([0.03, 0.01])
    assert spans.mean_ms(ev, "nof.step") == pytest.approx(20.0)
    assert spans.mean_ms(ev, "nof.adam") is None
    assert spans.ranges(None, lambda n: True) == []


@pytest.mark.parametrize("name", ["nof_step.host_ms.refine",
                                  "nof_step.host_ms.online"])
def test_step_host_ms(name):
    ev = [_ev("stage:nof.step", 20.0), _ev("stage:nof.step", 40.0),
          _ev("stage:nof.render", 5.0), _ev("bench:train", 70.0)]
    assert _read(name, {"events": ev, "trace_units": 2}) == \
        pytest.approx(30.0)
    assert _read(name, {"events": ev[2:], "trace_units": 2}) is None


def test_prep_ms_per_batch():
    ev = [_ev("stage:nof.prep", 400.0), _ev("stage:nof.step", 20.0),
          _ev("stage:scene.bounds", 100.0)]
    assert _read("nof_runner.prep_ms.online", {"events": ev}) == \
        pytest.approx(400.0)
    assert _read("nof_runner.prep_ms.online", {"events": ev[1:]}) is None


@pytest.mark.parametrize("window,want", [
    # custom.track: 2 traced frames; units are frames
    ({"trace_units": 2, "units": 50, "frames": 50}, 40.0),
    # custom.online: one traced batch period; 3 periods over 12 frames
    ({"trace_units": 1, "units": 3, "frames": 12}, 20.0)])
def test_pull_wait_sums_the_tracker_sites_per_frame(window, want):
    ev = [_ev("stage:pull.track.ba", 50.0), _ev("stage:pull.track.ransac",
                                                 25.0),
          _ev("stage:pull.track.frame", 5.0),
          _ev("stage:pull.nof.chunk", 500.0), _ev("stage:nof.step", 30.0),
          _ev("stage:pull.track.ba", 70.0, cat="gpu_user_annotation")]
    assert _read("tracker.pull_wait_ms", dict(window, events=ev)) == \
        pytest.approx(want)
    assert _read("tracker.pull_wait_ms",
                 dict(window, events=ev, frames=0)) is None


PARENT_LIKE = [_ev("stage:ba_finish_prev", 150.0), _ev("stage:detect", 15.0),
               _ev("bench:train", 40.0), _ev("sgemm", 1.0, cat="kernel")]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_spans_reads_nothing(name):
    """A slice without the program's span ranges (an older port, whose
    `stage:` ranges are its stages alone), or no slice, gives no number
    and raises nothing."""
    base = {"trace_units": 1, "units": 3, "frames": 12}
    for w in (dict(base), dict(base, events=None),
              dict(base, events=PARENT_LIKE)):
        assert _read(name, w) is None


@pytest.mark.parametrize("workload,want", [
    ("custom.refine", {"nof_step.host_ms.refine"}),
    ("custom.online", {"nof_step.host_ms.online",
                       "nof_runner.prep_ms.online", "tracker.pull_wait_ms"}),
    ("custom.track", {"tracker.pull_wait_ms"})])
def test_traced_run_reports_the_span_metrics(tmp_path, workload, want):
    res, err = tiny.run(str(tmp_path), workload, seconds=0.3, trace=True)
    assert res["correct"] is True, err
    got = {k for k in res["metrics"] if k in SPAN_METRICS}
    assert got == want
    for k in want:
        assert res["metrics"][k]["value"] > 0.0


def test_program_without_span_ranges_runs_traced(tmp_path, monkeypatch):
    """The benchmark over a program whose spans mark no range in the trace
    (an older port): the traced run ends correct and leaves the span
    metrics out."""
    monkeypatch.setattr(profiling, "_recording", lambda: False)
    res, err = tiny.run(str(tmp_path), "custom.refine", seconds=0.3,
                        trace=True)
    assert res["correct"] is True, err
    assert not set(res["metrics"]) & set(SPAN_METRICS)
