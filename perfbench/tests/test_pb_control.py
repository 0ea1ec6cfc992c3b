"""The control comes out as not correct: the frozen reference with the
precision below the configuration's, put in the port's place, reads above
the cell's limits. The NOF's fp8 control runs here at a tiny size; the
tracker's TF32 control needs the card (TF32 exists only there) and runs
on it at the cell's own size: its frame size, and as many frames as the
warm-up and a window hold (`CELL_FRAMES`, from the window's 239-278
frames on the card)."""
import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.tools import control


# custom.track's 40 warm-up frames and a window of about 275 (239-278
# over 30 s on the H100)
CELL_FRAMES = 315


def _fails(workload, got, limits_dir=None):
    lim = harness.load_json(f"{limits_dir or harness.HERE}/limits/"
                            f"{workload}.json")
    return any(v > lim[k] for k, v in got.items())


@pytest.mark.parametrize("workload", ["custom.refine", "ho3d.refine"])
@pytest.mark.parametrize("kind", ["fp8", "half_batch"])
def test_nof_control_fails(tmp_path, workload, kind):
    bj, bdir = tiny.make(str(tmp_path))
    got = control.readings(workload, 7, [kind], device="cpu",
                           benchmark_json=bj, bench_dir=bdir)
    assert _fails(workload, got[kind]), got


@pytest.mark.cuda
def test_tracker_tf32_control_fails(card):
    got = control.readings("custom.track", 8, ["tf32"], frames=CELL_FRAMES,
                           device=card)
    assert _fails("custom.track", got["tf32"]), got
