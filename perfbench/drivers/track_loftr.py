"""Pose-only tracking through LoFTR: `BundleSdf.run` over the orbit with
the NOF off and the matcher that the tracker config's `loftr_ckpt` selects.

Set-up renders the orbit on the card, draws the configuration's LoFTR
weights (`reference/loftr_plain.py::seeded_state_dict` from its
`matcher.seed`, its `coarse_gain` multiplied in), writes them as a
checkpoint in `outdoor_ds.ckpt`'s layout into the run's scratch
directory and points `loftr_ckpt` at it, so that
`BundleSdf` builds its `LoftrMatcher` from the file as it does for a
user's; then it tracks `warmup_frames` frames. The window is `track`'s:
every `run` call until `--seconds` have passed, closed after
`flush_pipeline()`. With `--trace 1`, `traced_frames` frames run under the
profiler before the window opens; the program's `loftr.*` counters are read
around that slice and around the window, and the device time of the work
launched inside each span of the slice is kept for the readers.

A `Probe` records, from the first frame on, the matches each `find_corres`
call handed on (mapped back to full-resolution pixels, before map points)
with the frame ids of its pairs, and, for every `compare_every`-th frame
of the window, each `predict` call's crops, on the device, with its
outputs. Once the window has closed:

- the net: `loftr_plain` in float32 runs on the crops of every
  `compare_every`-th window frame's calls with the same weights, and
  `compare_matches` reads `loftr_missed_share` and `loftr_uv1_gap_px`
  (compared) and `loftr_conf_gap` (noted only);
- the tracker after the net: the frozen reference tracks the same frames
  from the first with a `Replay` matcher, whose `match_frames` hands back
  the port's recorded matches call by call (the frozen code's frame-keyed
  branch, unedited), and each window frame's pose is compared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import time

import numpy as np
import torch

from perfbench import trace
from perfbench.drivers import common, tracking
from perfbench.harness import Outcome
from perfbench.reference import loftr_plain

COUNTERS = ("loftr.pairs", "loftr.batches", "loftr.matches")


def weights(cell) -> dict:
    """The configuration's seeded LoFTR state_dict, in upstream's layout.
    One checkpoint for every run, as a deployment loads one: --seed moves
    the frames, not the net (drawn from --seed, the net's matches a pair
    ranged 184-356 over six seeds and the frame rate spread by 15 %)."""
    m = cell.config["matcher"]
    return loftr_plain.seeded_state_dict(
        loftr_plain.Config(), seed=int(m["seed"]), gains=m["coarse_gain"])


def with_checkpoint(cell, path: str):
    """@cell with its tracker config pointed at the checkpoint @path."""
    m = cell.config["matcher"]
    track = dict(cell.config["track"], loftr_ckpt=path,
                 loftr_amp=bool(m["amp"]))
    return dataclasses.replace(cell, config=dict(cell.config, track=track))


class Probe:
    """Records what the port's matcher path produced: `calls`, [(pair ids,
    [(N,5) matches mapped back])] of every `find_corres` call that matched,
    and, while `keep_crops` is set, `crops`, [(cropsA, cropsB, [(N,5)
    crop-space matches])] of every `predict` call."""

    def __init__(self):
        self.calls: list = []
        self.crops: list = []
        self.keep_crops = False
        self._pending = None

    @contextlib.contextmanager
    def installed(self, tracker):
        """Wrap @tracker's `find_corres`, its matcher's `predict` and the
        orchestrator's `map_matches_back` for the block."""
        from bundlesdf_tpu_torch import bundlesdf as bsdf
        matcher = tracker.matcher
        predict, find, back = (matcher.predict, tracker.find_corres,
                               bsdf.map_matches_back)

        def predict_probe(a, b):
            out = predict(a, b)
            if self.keep_crops:
                self.crops.append((a, b, out))
            return out

        def back_probe(uv, tfA, tfB):
            out = back(uv, tfA, tfB)
            if self._pending is not None:
                self._pending.append(np.array(out, copy=True))
            return out

        def find_probe(frame_pairs):
            self._pending = []
            try:
                return find(frame_pairs)
            finally:
                if self._pending:
                    self.calls.append(([(a.id, b.id) for a, b in frame_pairs],
                                       self._pending))
                self._pending = None

        matcher.predict = predict_probe
        tracker.find_corres = find_probe
        bsdf.map_matches_back = back_probe
        try:
            yield self
        finally:
            bsdf.map_matches_back = back
            del matcher.predict, tracker.find_corres


class Replay:
    """A frame-keyed matcher that hands back recorded matches: each
    `match_frames` call gets the next recorded call's, provided its pairs'
    frame ids are the recorded ones; otherwise `mismatch` is counted and
    the pairs get no matches."""

    def __init__(self, calls):
        self.calls = calls
        self.i = 0
        self.mismatch = 0

    def match_frames(self, frame_pairs):
        ids = [(a.id, b.id) for a, b in frame_pairs]
        if self.i >= len(self.calls) or self.calls[self.i][0] != ids:
            self.mismatch += 1
            return [np.zeros((0, 5)) for _ in frame_pairs]
        out = [np.array(m, copy=True) for m in self.calls[self.i][1]]
        self.i += 1
        return out


def plain_outputs(records, sd, device, control=None):
    """The float32 reference's kept matches for the records of
    `Probe.crops`: [[(N,5) float32 crop-space matches] per pair] per
    record, in batches of at most 16 pairs. @control: a context manager
    factory taking the reference net (a planted fault or a lower
    precision)."""
    net = loftr_plain.load(sd).to(device)
    out = []
    with torch.inference_mode(), (control(net) if control
                                  else contextlib.nullcontext()):
        for a, b, _ in records:
            pairs = []
            for s in range(0, len(a), 16):
                r = net(a[s:s + 16].float() / 255.0,
                        b[s:s + 16].float() / 255.0)
                r = {k: r[k].cpu().numpy() for k in ("uv0", "uv1", "conf")}
                for k in range(len(r["conf"])):
                    keep = r["conf"][k] > 0
                    pairs.append(np.concatenate(
                        [r["uv0"][k][keep], r["uv1"][k][keep],
                         r["conf"][k][keep][:, None]], -1))
            out.append(pairs)
    del net
    return out


def compare_matches(got, ref, thr: float, margin: float) -> dict:
    """The net's numbers, @got (the port's, or a control's) against @ref
    (the float32 reference's), both [[(N,5) crop-space matches] per pair]
    per call. A reference match is decided where its confidence is at
    least @thr + @margin. Two matches are the same where they join the same
    two coarse cells: uv0 equal, and uv1 in the same 8 px cell (uv1 is the
    cell's corner plus the fine offset, less than 4 px). Read:

    - `loftr_missed_share`: the share of the decided matches that @got
      lacks, over all pairs (the coarse stage). Not the worst pair's: a
      pair of fifty decided matches swings by a few of them, so the worst
      of a window's pairs reads 0.25-0.27 at bf16 and 0.30 in fp8 on four
      pairs, where the window's shares stay 2.5 times apart;
    - `loftr_uv1_gap_px`: the largest |uv1 difference| (Euclidean, crop
      pixels) on the decided matches both have (the fine stage);
    - `loftr_conf_gap`: the mean |confidence difference| on those matches.
      The run notes it and does not compare it: the seeded net's
      similarities are so large that its dual softmax is saturated, and
      the whole net in fp8 reads no higher than bf16 (0.0008-0.0013
      against 0.0011-0.0018 on the H100), so no limit tells a lower
      precision from the port's.

    Also the counts and spreads behind them."""
    shares, dus, dcs = [], [0.0], []
    n_pairs = n_got = n_ref = n_dec = n_lack = 0
    for gc_, rc in zip(got, ref):
        for g, r in zip(gc_, rc):
            n_pairs += 1
            n_got += len(g)
            n_ref += len(r)
            have = {_cells(row): row for row in g}
            dec = [row for row in r if row[4] >= thr + margin]
            n_dec += len(dec)
            lack = 0
            for row in dec:
                mine = have.get(_cells(row))
                if mine is None:
                    lack += 1
                    continue
                dus.append(float(np.hypot(*(np.float64(mine[2:4])
                                            - np.float64(row[2:4])))))
                dcs.append(abs(float(mine[4]) - float(row[4])))
            n_lack += lack
            if dec:
                shares.append(lack / len(dec))
    return {"loftr_missed_share": n_lack / max(n_dec, 1),
            "loftr_uv1_gap_px": max(dus),
            "loftr_conf_gap": float(np.mean(dcs)) if dcs else 0.0,
            "pairs": n_pairs, "matches": n_got, "ref_matches": n_ref,
            "decided": n_dec, "missed": n_lack,
            "missed_share_median": float(np.median(shares or [0.0])),
            "missed_share_max": max(shares, default=0.0),
            "conf_gap_max": max(dcs, default=0.0),
            "uv1_gap_mean": float(np.mean(dus[1:])) if dcs else 0.0}


def _cells(row) -> tuple:
    """The two coarse cells a match joins: uv0 and uv1 rounded to 8 px."""
    return (float(row[0]), float(row[1]), round(float(row[2]) / 8.0),
            round(float(row[3]) / 8.0))


def replay_poses(cell, sc, calls, n_frames: int, flush: bool = True):
    """The frozen reference's answers to the first @n_frames frames of @sc
    with the recorded matcher calls @calls: ({id: pose}, mismatches)."""
    mod = tracking.reference()
    matcher = Replay(calls)
    tracker = tracking.make_tracker(mod, cell,
                                    os.path.join(cell.scratch, "ref"),
                                    quiet=True, matcher=matcher)
    feed = tracking.Feed(tracker, sc)
    while feed.i < n_frames:
        feed.step()
    if flush:
        feed.flush()
    poses = feed.poses
    del feed, tracker
    common.release(cell.device)
    return poses, matcher.mismatch


def _by_thirds(ids, calls, stages) -> list:
    """Lines of what a window frame did, by thirds of the window: the
    LoFTR pairs a frame (from the recorded `find_corres` calls) and the
    host seconds a frame of the stages that grew the most."""
    parts = np.array_split(np.asarray(ids), 3)
    pairs = {}
    for ps, _ in calls:
        for a, b in ps:
            pairs[max(a, b)] = pairs.get(max(a, b), 0) + 1
    out = ["LoFTR pairs a frame by thirds of the window: " + " ".join(
        f"{np.mean([pairs.get(int(i), 0) for i in x]):.2f}"
        for x in parts if len(x))]
    sp = np.array_split(np.arange(len(stages)), 3)
    if stages and all(len(x) for x in sp):
        names = sorted({k for st in stages for k in st})
        ms = {k: [1e3 * np.mean([stages[j].get(k, 0.0) for j in x])
                  for x in sp] for k in names}
        top = sorted(names, key=lambda k: ms[k][0] - ms[k][-1])[:4]
        out.append("host ms a frame by thirds, the stages that grew most: "
                   + "; ".join(f"{k} " + " ".join(f"{v:.2f}"
                                                  for v in ms[k])
                               for k in top))
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, (0, 0.0))[0] - before.get(k, (0, 0.0))[0]
            for k in COUNTERS}


def build(cell, sd):
    """The port's tracker as a user's `loftr_ckpt` builds it, with the
    checkpoint of @sd written into the run's scratch directory."""
    mod = tracking.program()
    path = os.path.join(cell.scratch, "loftr", "outdoor_ds_seeded.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    loftr_plain.write_checkpoint(path, sd)
    tracker = tracking.make_tracker(mod, with_checkpoint(cell, path),
                                    os.path.join(cell.scratch, "out"))
    if type(tracker.matcher).__name__ != "LoftrMatcher":
        raise RuntimeError(f"loftr_ckpt built a "
                           f"{type(tracker.matcher).__name__}")
    return tracker


def run(cell):
    from bundlesdf_tpu_torch.utils import profiling
    dev = cell.device
    p = cell.traffic
    lim = cell.limits
    parts = common.Parts(cell.t_start)
    tracking.program()
    parts.mark("imports")
    sc = tracking.frames(cell)
    parts.mark("render")
    sd = weights(cell)
    tracker = build(cell, sd)
    thr = float(tracker.matcher.cfg.match_thr)
    shape = {"cfg": dataclasses.asdict(tracker.matcher.cfg),
             "size": int(tracker.cfg_track["feature_corres"].get("resize",
                                                                  400))}
    probe = Probe()
    feed = tracking.Feed(tracker, sc)
    parts.mark("build")
    with probe.installed(tracker):
        with torch.profiler.record_function("bench:warmup"):
            while feed.i < int(p["warmup_frames"]):
                feed.step()
            feed.flush()
        common.sync(dev)
        setup_s = parts.mark("warmup")
        cell.note(parts.line())

        events, slice_counts, by_range = None, None, {}
        if cell.trace:
            n_tr = int(p["traced_frames"])
            path = os.path.join(cell.scratch, "trace", "trace.json")
            snap = profiling.snapshot()
            with trace.device_trace(path):
                for _ in range(n_tr):
                    feed.step()
                feed.flush()
            slice_counts = _delta(snap, profiling.snapshot())
            by_range = profiling.device_ms_by_range(trace.load(path))
            events = trace.slim(path)
            gc.collect()
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)

        first = feed.i
        n_stage0 = len(tracker.stage_stats)
        every = max(1, int(lim.get("compare_every", 1)))
        snap = profiling.snapshot()
        times = []
        t0 = time.perf_counter()
        while True:
            probe.keep_crops = (feed.i - first) % every == 0
            t = time.perf_counter()
            feed.step()
            times.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= cell.seconds:
                break
        feed.flush()
        common.sync(dev)
        wall = time.perf_counter() - t0
        probe.keep_crops = False
        window_counts = _delta(snap, profiling.snapshot())
    ids = list(range(first, feed.i))
    window = {"stages": tracker.stage_stats[n_stage0:], "frames": len(ids),
              "units": len(ids), "events": events, "window_s": wall,
              "nof_s": 0.0, "device_kind": common.device_kind(dev),
              "loftr_shape": shape, "loftr_window": window_counts,
              "range_device_ms": by_range}
    if events is not None:
        window["trace_units"] = int(p["traced_frames"])
        window["loftr_slice"] = slice_counts
    prog_poses = dict(feed.poses)
    failed = sum(feed.failed.get(i, True) for i in ids)
    peak = common.memory_peak(dev)
    n_fed = feed.i
    calls, records = probe.calls, probe.crops
    del feed, tracker, probe
    common.release(dev)

    t1 = time.perf_counter()
    ref = plain_outputs(records, sd, dev)
    got = [[np.asarray(m) for m in out] for _, _, out in records]
    del records
    common.release(dev)
    net = compare_matches(got, ref, thr, float(lim.get("decided_margin",
                                                       0.0)))
    t2 = time.perf_counter()
    ref_poses, mismatch = replay_poses(cell, sc, calls, n_fed)
    if mismatch:
        ref_poses = {}
    t_gap, r_gap = common.pose_gaps(prog_poses, ref_poses, ids)
    compared = [(k, net[k], float(lim.get(k, 0.0)))
                for k in ("loftr_missed_share", "loftr_uv1_gap_px")]
    compared += [("pose_gap_mm", t_gap, float(lim.get("pose_gap_mm", 0.0))),
                 ("pose_gap_deg", r_gap, float(lim.get("pose_gap_deg",
                                                       0.0)))]
    if dev.startswith("cuda"):
        cell.note(f"card {common.device_label()}")
    cell.note(f"setup_s {setup_s!r} window_s {wall!r} frames {len(ids)} "
              f"failed {failed}")
    n_pairs = max(net["pairs"], 1)
    per_pair = (window_counts["loftr.matches"]
                / max(window_counts["loftr.pairs"], 1))
    cell.note(f"loftr window counters {window_counts}: {per_pair:.1f} "
              f"matches a pair above {thr}")
    cell.note(f"compared every {every}th window frame: {len(got)} predict "
              f"calls, {net['pairs']} pairs, {net['matches'] / n_pairs:.1f} "
              f"matches a pair (reference {net['ref_matches'] / n_pairs:.1f},"
              f" decided {net['decided'] / n_pairs:.1f}); missed share "
              f"median pair {net['missed_share_median']:.4f}, worst pair "
              f"{net['missed_share_max']:.4f}; conf gap mean "
              f"{net['loftr_conf_gap']:.6f}, largest "
              f"{net['conf_gap_max']:.4f}; {t2 - t1:.1f} s; tracker replay of "
              f"{n_fed} frames, {len(calls)} matcher calls, {mismatch} "
              f"mismatched, {time.perf_counter() - t2:.1f} s")
    thirds = np.array_split(np.asarray(times), 3)
    cell.note("frames/s by thirds of the window: " + " ".join(
        f"{len(x) / max(float(x.sum()), 1e-9):.3f}" for x in thirds))
    for line in _by_thirds(ids, calls, window["stages"]):
        cell.note(line)
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
        net_ms = by_range.get("loftr.net")
        if net_ms is not None and out.busy_s:
            cell.note(f"loftr.net ranges: {net_ms:.3f} device ms of the "
                      f"slice's {1e3 * out.busy_s:.3f} busy "
                      f"({0.1 * net_ms / out.busy_s:.1f} %); slice counters "
                      f"{slice_counts}")
    return out
