"""The readers of `nof_step.graph_share.online` / `.refine` on synthetic
traced slices: the replayed steps' share of the steps, and nothing where
the slice holds no replay or no slice was traced."""
import pytest

from perfbench import harness

NAMES = ("nof_step.graph_share.online", "nof_step.graph_share.refine")


def _ev(name, ms, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "ts": 0.0, "dur": ms * 1e3, "name": name,
            "args": {"stream": 1}}


@pytest.mark.parametrize("name", NAMES)
def test_share_of_steps_that_replayed(name):
    read = harness.load_metric(harness.HERE, name)
    # a batch's eager first step, then three replays (one capture between)
    ev = ([_ev("stage:nof.step", 30.0), _ev("stage:nof.graph.capture", 90.0)]
          + [_ev("stage:nof.step", 2.0) for _ in range(3)]
          + [_ev("stage:nof.graph.replay", 1.5) for _ in range(3)]
          + [_ev("stage:nof.graph.replay", 1.5, cat="gpu_user_annotation"),
             _ev("bench:train", 40.0)])
    assert read({"events": ev}) == pytest.approx(75.0)
    assert read({"events": ev[2:]}) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NAMES)
def test_no_replay_reads_nothing(name):
    read = harness.load_metric(harness.HERE, name)
    eager = [_ev("stage:nof.step", 20.0), _ev("stage:nof.render", 8.0)]
    assert read({"events": eager}) is None
    assert read({"events": None}) is None
    assert read({}) is None
