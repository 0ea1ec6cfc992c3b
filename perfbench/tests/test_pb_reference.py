"""The frozen reference agrees with the port at a small size on the CPU:
the NOF step's first three steps, the tracker's poses, and in the online
loop every NOF batch's first three steps and step count and the poses,
both where the reference trains its own batches and where it follows the
port's."""
import os

from perfbench import harness
from perfbench.drivers import common, refine, tracking
from perfbench.tests import tiny


def _cell(tmp, workload, seed=4):
    bj, bdir = tiny.make(str(tmp))
    _, cell = harness.prepare(workload, seed, 0, False, "cpu",
                              benchmark_json=bj, bench_dir=bdir,
                              scratch=str(tmp / "s"))
    return cell


def test_nof_step_agrees(tmp_path):
    cell = _cell(tmp_path, "custom.refine")
    kf = refine.keyframes(cell)
    got = {}
    for side, mod in (("port", refine.program()),
                      ("reference", refine.reference())):
        common.seed_host_rngs(0)
        r = refine.build(mod, refine.refine_config(cell, mod), kf, cell.seed,
                         "cpu")
        got[side] = refine.first_steps(r)
    loss, grad, change, moved = refine.compare(got["port"],
                                               got["reference"])
    assert (loss, grad, change) == (0.0, 0.0, 0.0)
    assert "table" in moved and len(moved) >= 10


def _port_poses(cell, sc, n, flush):
    tracker = tracking.make_tracker(tracking.program(), cell,
                                    os.path.join(cell.scratch, "port"))
    feed = tracking.Feed(tracker, sc)
    while feed.i < n:
        feed.step()
    if flush:
        feed.flush()
    return feed.poses, tracker


def test_tracker_agrees(tmp_path):
    cell = _cell(tmp_path, "custom.track")
    sc = tracking.frames(cell)
    port, _ = _port_poses(cell, sc, 8, True)
    ref = tracking.replay(cell, sc, 8, True)
    assert sorted(port) == list(range(8))
    assert common.pose_gaps(port, ref, range(8)) == (0.0, 0.0)


def test_online_loop_agrees(tmp_path):
    from bundlesdf_tpu_torch.nof.runner import NofRunner
    from perfbench.drivers import online
    cell = _cell(tmp_path, "custom.online")
    sc = tracking.frames(cell)
    tracker = tracking.make_tracker(tracking.program(), cell,
                                    os.path.join(cell.scratch, "port"))
    feed = tracking.Feed(tracker, sc)
    probe = online.BatchProbe()
    plain = probe.install(NofRunner)
    synced, gens = {}, {}
    try:
        while feed.i < 36:
            n_b = tracker.pipeline_stats["n_batches"]
            feed.step()
            if online.batch_finished(tracker, n_b):
                synced[tracker.cnt_nerf] = online.keyframe_poses(tracker)
                gens[tracker.cnt_nerf] = tracker.nerf.generator.get_state()
    finally:
        NofRunner._train_chunk = plain
    prog = dict(enumerate(probe.readings()))
    assert len(synced) >= 2 and sorted(prog) == sorted(synced)
    own = online.ReferenceBatches()
    own_poses = online.reference_replay(cell, sc, 36, own)
    fed = online.ReferenceBatches(gens, synced)
    fed_poses = online.reference_replay(cell, sc, 36, fed)
    for poses, batches in ((own_poses, own), (fed_poses, fed)):
        assert sorted(batches.first) == sorted(prog)
        gap = online.steps_gap([r["steps"] for r in prog.values()],
                               batches.n_iters, 0, [])
        nums = online.compare(cell, feed.poses, prog, poses, batches.first,
                              range(35), gap)
        assert all(v == 0.0 for _, v, _ in nums), nums
    for k, v in synced.items():
        assert common.pose_gaps(dict(enumerate(v)),
                                dict(enumerate(own.own_synced[k])),
                                range(len(v))) == (0.0, 0.0)
