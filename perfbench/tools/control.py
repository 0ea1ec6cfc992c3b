"""Read the comparison's upper end on the chip: the frozen reference with a
control or a fault switched on (`reference/control.py`), put in the port's
place and compared with the plain reference, at the cell's own size.

    python3 perfbench/tools/control.py --workload custom.refine \
        --kinds fp8 half_batch --seeds 11 12 13 [--frames N]

A training cell compares the first three steps; a tracking cell replays
`--frames` frames and compares their poses. In the online cell the plain
reference trains every NOF batch whole; the control's replay starts each
batch from the plain one's generator state and syncs back the poses the
plain one's batch synced, as the cell's own comparison does with the
port's, and every batch's first three steps are compared besides. Prints
one JSON line a seed and kind with every number the cell compares but the
step count, which no control changes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload, seed, kinds, frames=None, device="cuda",
             benchmark_json=None, bench_dir=None):
    """{kind: {number: value}} for @kinds at @seed."""
    from perfbench import harness
    from perfbench.drivers import common, refine, tracking
    from perfbench.reference import control
    _, cell = harness.prepare(workload, seed, 0, False, device,
                              benchmark_json=benchmark_json,
                              bench_dir=bench_dir,
                              scratch=tempfile.mkdtemp(prefix="control_"))
    out = {}
    if cell.traffic["driver"] == "refine":
        mod = refine.reference()
        kf = refine.keyframes(cell)
        cfg = refine.refine_config(cell, mod)

        def steps():
            common.seed_host_rngs(0)
            r = refine.build(mod, cfg, kf, cell.seed, device)
            s = refine.first_steps(r)
            del r
            common.release(device)
            return s
        plain = steps()
        for k in kinds:
            with control.KINDS[k]():
                got = steps()
            lg, gg, cg, _ = refine.compare(got, plain)
            out[k] = {"loss_gap": lg, "grad_gap": gg, "change_gap": cg}
        return out
    sc = tracking.frames(cell)
    if cell.traffic["driver"] == "online":
        from perfbench.drivers import online
        plain = online.ReferenceBatches()
        plain_poses = online.reference_replay(cell, sc, frames, plain)
        ids = sorted(plain_poses)
        for k in kinds:
            got = online.ReferenceBatches(plain.gen_after, plain.own_synced)
            with control.KINDS[k]():
                poses = online.reference_replay(cell, sc, frames, got)
            out[k] = {n: v for n, v, _ in online.compare(
                cell, poses, got.first, plain_poses, plain.first, ids, 0)
                if n != "nof_steps_gap"}
            out[k]["batches"] = len(got.first)
        return out
    flush = cell.traffic["driver"] == "track"
    plain = tracking.replay(cell, sc, frames, flush)
    ids = sorted(plain)
    for k in kinds:
        with control.KINDS[k]():
            got = tracking.replay(cell, sc, frames, flush)
        t, r = common.pose_gaps(got, plain, ids)
        out[k] = {"pose_gap_mm": t, "pose_gap_deg": r}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kinds", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(args.workload, seed, args.kinds, args.frames)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
