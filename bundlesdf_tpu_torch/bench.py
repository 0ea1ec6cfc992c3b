"""Benchmark of the port: NOF training step rate, online tracking FPS and
online pipeline FPS.

    python -m bundlesdf_tpu_torch.bench [--device cuda] \
        [--orb_features tests/fixtures/tracker_orb_bench70.npz] [--repeat N]

Port of the repo's `bench.py`. It prints the same three JSON lines, with
the same `metric` names, `unit` strings and `vs_baseline = value / 10`,
on the same workloads:

- `nof_train_steps_per_sec`: `NofRunner` at `default_nerf_config()` on 5
  frames of the 480x640 orbit; one warm-up chunk, then the best of 3
  timed runs of 2 x `scan_chunk` steps;
- `tracking_fps`: the tracker alone (NOF off, `SPDLOG` 0) over 70 frames
  of `cube_orbit_sequence(obj_size=0.10, full_angle=1.2)`, the median
  frame time after frame 40;
- `pipeline_fps`: the same frames with the NOF on (`start_nerf_keyframes`
  5, `sync_max_delay` 4, `scan_chunk` 10), the mean over the same tail.

Each line also carries `device`, the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
them ("cpu" on the CPU), and with `--repeat N` every repeat's values and
their spread; `value` is then the median repeat's. On the card the device
times come from `torch.profiler` traces, as the union of the device
intervals on all streams (`utils/profiling.py`), and a failed trace fails
the run; the tracking line's timed frames run untraced and a second pass
over the same frames is traced. On the CPU there is no device timeline
and the device fields are left out. The pipeline's device floor covers
the steady frames its `value` averages and the NOF steps dispatched while
they ran, at this run's measured device ms per step and per frame.

The two tracking lines detect ORB features live, with the port's own
detector (`matcher/orb.py`) on the run's device. `--orb_features` replays
stored features instead (written by `tests/fixtures/gen_tracker_orb.py
--sequence bench70` with cv2), so detection is left out of the timed
frames: the difference between the two is detection's cost.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.utils.profiling import (Timer, device_events,
                                                 device_ms_by_range,
                                                 device_trace,
                                                 interval_union_ms,
                                                 load_trace, trace_path)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's ~10 steps/s and "near real-time" ~10 frames/s (bench.py)
BASELINE = 10.0
# one H100's HBM rate (NVIDIA data sheet, SXM part, 700 W)
HBM_BYTES_S = 3.35e12
HBM_PEAK = "3.35 TB/s (H100 SXM data sheet)"
N_FRAMES, WARMUP, N_TRACED = 70, 40, 10


def synthetic():
    """The repo's synthetic sequences (`tests/synthetic.py`, pure numpy)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import synthetic as syn
    return syn


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _busy(events):
    """(union, sum) of a trace's device intervals, ms; raises on a trace
    without device events."""
    ev = device_events(events)
    if not ev:
        raise RuntimeError("the profiler trace holds no device events")
    return interval_union_ms(ev), sum(t - s for s, t, *_ in ev) / 1e3


def _traced_device_ms(fn, device):
    """Run @fn under a profiler trace of the card; (device-busy ms, summed
    device-event ms)."""
    tmp = tempfile.mkdtemp(prefix="bsdf_bench_trace_")
    try:
        with device_trace(tmp, device):
            fn()
        return _busy(load_trace(trace_path(tmp)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _median_run(runs):
    """The run whose value is the median (the lower middle for an even
    count), with every run's values and their spread attached."""
    values = [r["value"] for r in runs]
    rec = dict(sorted(runs, key=lambda r: r["value"])[(len(runs) - 1) // 2])
    if len(runs) > 1:
        rec["repeats"] = {k: [r.get(k) for r in runs] for k in (
            "value", "device_ms_per_step", "device_ms_per_frame",
            "wall_ms_median") if any(k in r for r in runs)}
        med = float(np.median(values))
        rec["spread"] = {"min": min(values), "max": max(values),
                         "rel": round((max(values) - min(values)) / med, 4)}
    return rec


# ---------------------------------------------------------------------------
# nof_train_steps_per_sec
# ---------------------------------------------------------------------------
def nof_workload(device, H=480, W=640, cfg_overrides=None):
    """`NofRunner` at the online workload (bench.py:244-256): 5 frames of
    the orbit, `default_nerf_config()`."""
    from bundlesdf_tpu_torch.config import default_nerf_config
    from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
    from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM
    seq = synthetic().cube_orbit_sequence(n_frames=5, H=H, W=W, radius=0.45,
                                          obj_size=0.08)
    translation = np.zeros(3)
    sc = 0.9 / 0.6
    cfg = default_nerf_config()
    cfg.update(dict(sc_factor=sc, translation=translation.tolist()))
    cfg.update(cfg_overrides or {})
    poses_gl = seq["cam_in_obs"] @ GLCAM_IN_CVCAM
    rgbs, depths, masks, normals, poses = preprocess_frame_data(
        seq["colors"].copy(), seq["depths"].copy(), seq["masks"].copy(), None,
        poses_gl.copy(), sc, translation)
    return NofRunner(cfg, rgbs, depths, masks, normals, poses, seq["K"],
                     device=device)


def nof_roofline(runner, device_ms) -> dict:
    """The bytes one training step must move at least, against the
    measured device ms: every level gathers R*S*8 corner rows in the
    forward and scatters as many in the backward (the port has no run
    dedup), and Adam reads the table, its gradient and both moments and
    writes back the table and the moments. The bound is those bytes at
    the card's HBM rate."""
    spec = runner.spec.grid
    R = runner.tcfg.n_rand
    S = runner.rcfg.n_samples + runner.rcfg.n_samples_around_depth
    C = spec.level_dim
    cb = 2 if spec.table_bf16 else 4     # gathered feature / gradient bytes
    m = spec.n_levels * R * S * 8
    table = runner.field.table
    tb = table.element_size()
    traffic = (m * (4 + C * tb + C * cb)      # gather: ids, rows, features
               + m * (4 + C * cb)             # scatter: ids and values
               + 7 * table.numel() * tb)  # Adam: p, g, m, v in; p, m, v out
    bound_ms = traffic / HBM_BYTES_S * 1e3
    return {
        "rows_per_step": int(2 * m),
        "bytes_per_step": int(traffic),
        "hbm_bound_ms": round(bound_ms, 4),
        "hbm_gbps_achieved": round(traffic / (device_ms * 1e-3) / 1e9, 1),
        "hbm_frac": round(traffic / (device_ms * 1e-3) / HBM_BYTES_S, 4),
        "hbm_peak": HBM_PEAK,
        "bound": "hbm-bytes",
        "bound_frac": round(bound_ms / device_ms, 4),
    }


def bench_nof(device="cuda", repeat=1, H=480, W=640, cfg_overrides=None):
    """The `nof_train_steps_per_sec` record (bench.py:232-286) and the
    runner it trained."""
    device = resolve_device(device)
    runner = nof_workload(device, H, W, cfg_overrides)
    label = device_label(device)
    m = runner.train(n_steps=runner.scan_chunk)      # warm-up; a host pull
    runs = []
    for _ in range(repeat):
        n = 2 * runner.scan_chunk
        timer = Timer(device=device)   # each span waits for the card
        for k in range(3):
            with timer.span(f"run {k}"):
                m = runner.train(n_steps=n)
        steps_per_sec = n / min(timer.totals.values())
        rec = {
            "metric": "nof_train_steps_per_sec",
            "value": round(steps_per_sec, 2),
            "unit": "steps/s (2048 rays x 192 samples, 4-level grid)",
            "vs_baseline": round(steps_per_sec / BASELINE, 2),
            "device": label,
        }
        if device.type == "cuda":
            busy, summed = _traced_device_ms(
                lambda: runner.train(n_steps=runner.scan_chunk), device)
            dev_ms = busy / runner.scan_chunk
            rec["device_ms_per_step"] = round(dev_ms, 4)
            # the per-kernel sum, which counts overlapping work twice
            rec["device_ms_sum_per_step"] = round(
                summed / runner.scan_chunk, 4)
            rec["util"] = nof_roofline(runner, dev_ms)
        runs.append(rec)
    if not np.isfinite(m["loss"]).all():
        raise RuntimeError("nof bench: non-finite loss")
    return _median_run(runs), runner


# ---------------------------------------------------------------------------
# tracking_fps and pipeline_fps
# ---------------------------------------------------------------------------
def tracking_sequence(H=480, W=640):
    """The 70 frames of bench.py's tracking and pipeline lines
    (bench.py:304-305, :398-399)."""
    return synthetic().cube_orbit_sequence(n_frames=N_FRAMES, H=H, W=W,
                                           radius=0.45, obj_size=0.10,
                                           full_angle=1.2)


def replay_matcher(orb_features, id_strs, device):
    """An `OrbMatcher` that replays the features stored per frame, in
    sequence order, in @orb_features (an .npz of
    `tests/fixtures/gen_tracker_orb.py`) for the frames @id_strs."""
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    fx = np.load(orb_features)
    if len(fx["counts"]) < len(id_strs):
        raise ValueError(f"{orb_features} holds {len(fx['counts'])} frames, "
                         f"the sequence {len(id_strs)}")
    offs = np.concatenate([[0], np.cumsum(fx["counts"])])
    feats = {id_str: (fx["uv"][offs[i]:offs[i + 1]],
                      fx["des"][offs[i]:offs[i + 1]])
             for i, id_str in enumerate(id_strs)}
    return OrbMatcher(device=device, detector=lambda f: feats[f.id_str])


def orb_matcher(device, seq, orb_features=None):
    """An `OrbMatcher` that replays @orb_features for the frames of @seq,
    or that detects live on @device."""
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    if orb_features:
        return replay_matcher(orb_features, seq["id_strs"], device)
    return OrbMatcher(device=device)


def _track_config(tmp, overrides=None):
    """`default_track_config()` as bench.py runs it, with
    @overrides ({dotted.key: value}) on top."""
    from bundlesdf_tpu_torch.config import apply_dotted, default_track_config
    cfg = default_track_config()
    cfg["SPDLOG"] = 0            # no per-frame artifact dumps in the loop
    cfg["debug_dir"] = tmp
    cfg["stage_timing"] = True   # wall attribution table
    return apply_dotted(cfg, overrides)


def _track_frames(tracker, seq, n_frames, trace_dir=None, n_traced=0):
    """Track the first @n_frames of @seq; the wall seconds of each frame.
    With @trace_dir the last @n_traced frames run under a profiler trace of
    the card written there."""
    times = []
    with contextlib.ExitStack() as window:
        for i in range(n_frames):
            if trace_dir and i == n_frames - n_traced:
                window.enter_context(device_trace(trace_dir, tracker.device))
            t0 = time.perf_counter()
            tracker.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                        seq["id_strs"][i], mask=seq["masks"][i])
            times.append(time.perf_counter() - t0)
    tracker.flush_pipeline()
    return times


def _tracking_run(device, seq, orb_features, n_frames, warmup, label,
                  cfg_track_overrides):
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import default_nerf_config
    tmp = tempfile.mkdtemp(prefix="bsdf_bench_tracking_")

    def make_tracker():
        return BundleSdf(cfg_track=_track_config(tmp, cfg_track_overrides),
                         cfg_nerf=default_nerf_config(),
                         start_nerf_keyframes=10 ** 9,   # tracker only
                         matcher=orb_matcher(device, seq, orb_features),
                         device=device)
    try:
        # the timed pass runs untraced: the profiler's host cost per op
        # would land in a host-bound frame's wall time
        tracker = make_tracker()
        times = _track_frames(tracker, seq, n_frames)
        steady = np.asarray(times[-max(n_frames - warmup, 10):])
        fps = 1.0 / np.median(steady)
        rec = {
            "metric": "tracking_fps",
            "value": round(float(fps), 2),
            "unit": "frames/s (480x640, steady-state median, ORB matcher)",
            "vs_baseline": round(float(fps) / BASELINE, 2),
            "device": label,
        }
        if device.type == "cuda":
            # the device time of the last steady frames, from a second
            # pass over the same frames (the same work) traced on those
            n_traced = min(N_TRACED, n_frames)
            tdir = os.path.join(tmp, "trace")
            _track_frames(make_tracker(), seq, n_frames, tdir, n_traced)
            events = load_trace(trace_path(tdir))
            busy, summed = _busy(events)
            dev_ms = busy / n_traced
            per_prog = {(k if k.startswith("(") else f"stage:{k}"):
                        round(v / n_traced, 4)
                        for k, v in device_ms_by_range(events).items()}
            rec["device_ms_per_frame"] = round(dev_ms, 4)
            rec["device_fps"] = round(1000.0 / dev_ms, 2)
            rec["device_ms_sum_per_frame"] = round(summed / n_traced, 4)
            rec["device_ms_by_program"] = dict(
                sorted(per_prog.items(), key=lambda kv: -kv[1])[:4])
            ba_ms = per_prog.get("stage:ba_dispatch", 0.0)
            util = {"ba_device_ms": round(ba_ms, 4),
                    "ba_frac_of_frame": round(ba_ms / dev_ms, 4)}
            stats = getattr(tracker.bundler, "_last_ba_stats", None) or {}
            if "D" in stats:
                util.update(ba_pairs=stats["P"], ba_dense_pts=stats["D"])
            rec["util"] = util
        st = tracker.stage_stats[-max(n_frames - warmup, 10):]
        if st:
            keys = sorted({k for d in st for k in d})
            rec["wall_stage_ms"] = {
                k: round(float(np.median([d.get(k, 0.0) for d in st])) * 1e3,
                         3) for k in keys}
            rec["wall_ms_median"] = round(float(np.median(steady)) * 1e3, 3)
        return rec, tracker
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_tracking(device="cuda", orb_features=None, n_frames=N_FRAMES,
                   warmup=WARMUP, repeat=1, H=480, W=640,
                   cfg_track_overrides=None, seq=None):
    """The `tracking_fps` record (bench.py:292-380) over the first
    @n_frames of the 70-frame sequence (@seq: `tracking_sequence(H, W)`,
    rendered here unless given), and the tracker of its median run. The
    profiler window covers the last 10 frames. @H, @W and the overrides
    cut the workload to a test's size."""
    device = resolve_device(device)
    seq = tracking_sequence(H, W) if seq is None else seq
    label = device_label(device)
    runs = [_tracking_run(device, seq, orb_features, n_frames, warmup, label,
                          cfg_track_overrides) for _ in range(repeat)]
    rec = _median_run([r for r, _ in runs])
    return rec, next(t for r, t in runs if r["value"] == rec["value"])


def _pipeline_run(device, seq, orb_features, n_frames, warmup, label,
                  device_ms_per_step, device_ms_per_frame,
                  cfg_nerf_overrides, cfg_track_overrides):
    from bundlesdf_tpu_torch.bundlesdf import BundleSdf
    from bundlesdf_tpu_torch.config import default_nerf_config
    tmp = tempfile.mkdtemp(prefix="bsdf_bench_pipeline_")
    try:
        cfg_nerf = default_nerf_config()
        # bench.py:413-416: the tracker runs up to 4 keyframes ahead of the
        # NOF batch, which trains in chunks of 10 steps
        cfg_nerf["sync_max_delay"] = 4
        cfg_nerf["scan_chunk"] = 10
        cfg_nerf["save_dir"] = os.path.join(tmp, "nerf")
        cfg_nerf.update(cfg_nerf_overrides or {})
        tracker = BundleSdf(cfg_track=_track_config(tmp, cfg_track_overrides),
                            cfg_nerf=cfg_nerf,
                            start_nerf_keyframes=5,
                            matcher=orb_matcher(device, seq, orb_features),
                            device=device)
        times = []
        n_steady = min(max(n_frames - warmup, 10), n_frames)
        steps_before = 0
        _sync(device)
        t_run0 = time.perf_counter()
        for i in range(n_frames):
            if i == n_frames - n_steady:
                steps_before = _steps_dispatched(tracker)
            t0 = time.perf_counter()
            tracker.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
                        seq["id_strs"][i], mask=seq["masks"][i])
            times.append(time.perf_counter() - t0)
        t_frames = time.perf_counter() - t_run0
        # the stalls the frames paid, before the final drain (on_finish
        # joins the last batch and extracts the mesh after the video)
        ps_inloop = dict(tracker.pipeline_stats)
        steps_window = _steps_dispatched(tracker) - steps_before
        t_fin = time.perf_counter()
        tracker.on_finish()
        _sync(device)
        final_drain_s = time.perf_counter() - t_fin
        # the mean over the steady tail keeps the batches' stalls
        steady = np.asarray(times[-n_steady:])
        fps = 1.0 / float(steady.mean())
        ps = dict(tracker.pipeline_stats)
        nof_steps = int(ps.get("nof_steps_total", tracker.nerf.global_step
                               if tracker.nerf is not None else 0))
        rec = {
            "metric": "pipeline_fps",
            "value": round(float(fps), 2),
            "unit": "frames/s (tracking WITH concurrent 500-step NOF "
                    "batches, sync_max_delay=4, steady-state mean incl. "
                    "sync stalls)",
            "vs_baseline": round(float(fps) / BASELINE, 2),
            "device": label,
            "nof_batches_trained": tracker.cnt_nerf + 1,
            "nof_steps_trained": nof_steps,
            "median_fps": round(1.0 / float(np.median(steady)), 2),
            "mean_fps_full_run": round(n_frames / t_frames, 2),
            "stalls_s": {k: round(v, 3) for k, v in ps_inloop.items()
                         if k.endswith("_s")},
            "final_drain_s": round(final_drain_s, 3),
            "n_sync_blocks": ps.get("n_sync_blocks", 0),
        }
        if device_ms_per_step is not None \
                and device_ms_per_frame is not None:
            # one card executes every NOF step and every tracked frame: over
            # the steady frames that `value` averages, frames / (the device
            # seconds of those frames and of the NOF steps dispatched while
            # they ran) bounds the mean, from this run's measured device ms
            # a step and a frame
            dev_s = (steps_window * device_ms_per_step
                     + n_steady * device_ms_per_frame) / 1e3
            floor = n_steady / dev_s
            rec["device_floor_fps_single_chip"] = round(floor, 2)
            rec["overlap_efficiency"] = round(float(fps) / floor, 4)
            rec["floor_window"] = {"frames": n_steady,
                                   "nof_steps": steps_window}
            rec["device_ms_per_step"] = device_ms_per_step
            rec["device_ms_per_frame"] = device_ms_per_frame
            rec["note"] = ("floor = steady frames/(their NOF+tracking device "
                           "seconds) on ONE card, from the measured "
                           "device_ms_per_step and device_ms_per_frame")
        return rec, tracker
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _steps_dispatched(tracker):
    """NOF steps dispatched so far: the finished batches' and the one in
    flight's (the card runs at most two chunks behind)."""
    n = tracker.pipeline_stats.get("nof_steps_total", 0)
    if tracker.nerf is not None and tracker.nerf.training_in_flight:
        n += tracker.nerf.global_step - tracker._nerf_gs0
    return int(n)


def bench_pipeline(device="cuda", orb_features=None, n_frames=N_FRAMES,
                   warmup=WARMUP, repeat=1, H=480, W=640,
                   device_ms_per_step=None, device_ms_per_frame=None,
                   cfg_nerf_overrides=None, cfg_track_overrides=None,
                   seq=None):
    """The `pipeline_fps` record (bench.py:383-476) over the first
    @n_frames of the 70-frame sequence (@seq as in `bench_tracking`), and
    the tracker of its median run. The device floor needs both measured
    device times. @H, @W and the overrides cut the workload to a test's
    size."""
    device = resolve_device(device)
    seq = tracking_sequence(H, W) if seq is None else seq
    label = device_label(device)
    runs = [_pipeline_run(device, seq, orb_features, n_frames, warmup, label,
                          device_ms_per_step, device_ms_per_frame,
                          cfg_nerf_overrides, cfg_track_overrides)
            for _ in range(repeat)]
    rec = _median_run([r for r, _ in runs])
    return rec, next(t for r, t in runs if r["value"] == rec["value"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--orb_features", default="",
                    help="replay stored ORB features instead of detecting "
                         "them live")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run each line N times and report the spread")
    args = ap.parse_args(argv)
    nof, _ = bench_nof(args.device, repeat=args.repeat)
    print(json.dumps(nof), flush=True)
    seq = tracking_sequence()
    trk, _ = bench_tracking(args.device, args.orb_features or None,
                            repeat=args.repeat, seq=seq)
    print(json.dumps(trk), flush=True)
    pipe, _ = bench_pipeline(
        args.device, args.orb_features or None, repeat=args.repeat,
        device_ms_per_step=nof.get("device_ms_per_step"),
        device_ms_per_frame=trk.get("device_ms_per_frame"), seq=seq)
    print(json.dumps(pipe), flush=True)


if __name__ == "__main__":
    main()
