"""Read the comparison's ends in the LoFTR tracking cell, on the chip, at
the cell's own size: the port's reading (bf16, as the configuration
states) and those of controls and planted faults put in its place.

    python3 perfbench/tools/control_loftr.py --seeds 11 12 13 \
        [--workload custom_loftr.track] [--frames N] \
        [--kinds bf16 fp8 skip_last_coarse shift_fine_window tf32]

The port tracks the cell's first @frames frames (warm-up and window) with
the cell's seeded checkpoint, through the cell's probe; every `predict`
call after the warm-up keeps its crops. Against the float32 reference on
those crops (`plain_outputs`), the cell's net numbers (`compare_matches`,
the cell's margin) are read for:

- `bf16`: the port's own matches (the sound reading);
- `fp8`: the reference with every linear layer and convolution in float8
  (e4m3, one scale a tensor, `reference/control.py::quantize_e4m3`), the
  precision below the configuration's bf16, fine stage included;
- `skip_last_coarse`: the reference without the last coarse (self, cross)
  pair of layers, a planted fault of the coarse stage;
- `shift_fine_window`: the reference with the second image's fine windows
  one fine pixel off their coarse cell, a planted fault of the fine
  stage;

and the tracker's numbers for `tf32`: the frozen reference replays the
port's recorded matches with TF32 on, against its own replay with TF32
off, every frame after the warm-up. Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NET_KINDS = ("bf16", "fp8", "skip_last_coarse", "shift_fine_window")


@contextlib.contextmanager
def fp8(net):
    """@net's linear layers and convolutions, backbone, both transformers
    and the fine windows' projections, on e4m3-rounded inputs and weights
    for the block: the whole net one precision below the port's bf16."""
    import torch.nn.functional as F
    from torch import nn

    from perfbench.reference.control import quantize_e4m3
    layers = [m for m in net.modules()
              if isinstance(m, (nn.Linear, nn.Conv2d))]

    def rounded(m):
        if isinstance(m, nn.Linear):
            return lambda x: F.linear(quantize_e4m3(x),
                                      quantize_e4m3(m.weight), m.bias)
        return lambda x: m._conv_forward(quantize_e4m3(x),
                                         quantize_e4m3(m.weight), m.bias)

    for m in layers:
        m.forward = rounded(m)
    try:
        yield net
    finally:
        for m in layers:
            del m.forward


@contextlib.contextmanager
def skip_last_coarse(net):
    """@net without its last coarse (self, cross) pair for the block."""
    t = net.loftr_coarse
    layers, names = t.layers, t.layer_names
    t.layers, t.layer_names = layers[:-2], names[:-2]
    try:
        yield net
    finally:
        t.layers, t.layer_names = layers, names


@contextlib.contextmanager
def shift_fine_window(net):
    """@net with the second image's fine windows taken one fine pixel to
    the right of their coarse cell for the block (a planted fault of the
    fine stage: the expectation then lands about 2 crop pixels off)."""
    import torch
    fp = net.fine_preprocess
    plain = fp.forward

    def shifted(feat_f0, feat_f1, *rest):
        return plain(feat_f0, torch.roll(feat_f1, -1, dims=-1), *rest)

    fp.forward = shifted
    try:
        yield net
    finally:
        del fp.forward


CONTROLS = {"fp8": fp8, "skip_last_coarse": skip_last_coarse,
            "shift_fine_window": shift_fine_window}


def readings(workload, seed, kinds, frames=None, device="cuda",
             benchmark_json=None, bench_dir=None):
    """{kind: {number: value}} for @kinds at @seed, and the counts of the
    matches compared under "counts"."""
    import numpy as np

    from perfbench import harness
    from perfbench.drivers import common, track_loftr, tracking
    from perfbench.reference import control
    _, cell = harness.prepare(workload, seed, 0, False, device,
                              benchmark_json=benchmark_json,
                              bench_dir=bench_dir,
                              scratch=tempfile.mkdtemp(prefix="control_"))
    p, lim = cell.traffic, cell.limits
    warm = int(p["warmup_frames"])
    frames = frames or warm + 100
    sc = tracking.frames(cell)
    sd = track_loftr.weights(cell)
    tracker = track_loftr.build(cell, sd)
    thr = float(tracker.matcher.cfg.match_thr)
    probe = track_loftr.Probe()
    feed = tracking.Feed(tracker, sc)
    with probe.installed(tracker):
        while feed.i < frames:
            probe.keep_crops = feed.i >= warm
            feed.step()
        feed.flush()
    calls, records = probe.calls, probe.crops
    del feed, tracker, probe
    common.release(device)
    out = {}
    margin = float(lim.get("decided_margin", 0.0))
    names = ("loftr_missed_share", "loftr_uv1_gap_px", "loftr_conf_gap")
    if any(k in NET_KINDS for k in kinds):
        ref = track_loftr.plain_outputs(records, sd, device)
        for k in kinds:
            if k == "bf16":
                got = [[np.asarray(m) for m in o] for _, _, o in records]
            elif k in CONTROLS:
                got = track_loftr.plain_outputs(records, sd, device,
                                                control=CONTROLS[k])
            else:
                continue
            net = track_loftr.compare_matches(got, ref, thr, margin)
            out[k] = {n: net[n] for n in names}
            out.setdefault("counts", {})[k] = {
                n: net[n] for n in ("pairs", "matches", "ref_matches",
                                    "decided", "missed",
                                    "missed_share_median",
                                    "missed_share_max", "conf_gap_max",
                                    "uv1_gap_mean")}
    if "tf32" in kinds:
        ids = list(range(warm, frames))
        plain, _ = track_loftr.replay_poses(cell, sc, calls, frames)
        with control.tf32():
            got, _ = track_loftr.replay_poses(cell, sc, calls, frames)
        t, r = common.pose_gaps(got, plain, ids)
        out["tf32"] = {"pose_gap_mm": t, "pose_gap_deg": r}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="custom_loftr.track")
    ap.add_argument("--kinds", nargs="+",
                    default=list(NET_KINDS) + ["tf32"])
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
