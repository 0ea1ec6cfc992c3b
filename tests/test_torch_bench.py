"""The port's bench (`bundlesdf_tpu_torch/bench.py`) at a tiny size on the
CPU: its three records carry the JAX bench's metric names, unit strings,
`vs_baseline = value / 10` and keys; the device fields are left out on the
CPU; the pipeline's device floor is computed from the device times it is
given (the bench passes its own measured ones), not from constants; the
tracking lines detect live with the port's ORB, cv2 or not, unless
features are replayed.

Tolerances: `vs_baseline` and the floor are rounded as the records round
them (2 and 4 decimals), so they are held to half a unit of that
rounding."""
import os
import re
import sys

import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch import bench

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 60, 80
TINY_NERF = dict(N_rand=32, N_samples=8, N_samples_around_depth=8,
                 num_levels=2, finest_res=16, log2_hashmap_size=12,
                 n_trace_steps=32)
# a keyframe every frame, so the NOF starts at the 5th frame
EVERY_FRAME_KEYFRAME = {"keyframe.min_rot": 0}


def jax_bench_units():
    """metric -> unit string, read from the top-level bench.py."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    out = {}
    for m in re.finditer(r'"metric": "(\w+)",\s*"value": [^\n]*\n\s*'
                         r'"unit": ((?:"[^"]*"\s*)+),', src):
        out[m.group(1)] = "".join(re.findall(r'"([^"]*)"', m.group(2)))
    return out


def check_record(rec, metric):
    assert rec["metric"] == metric
    assert rec["unit"] == jax_bench_units()[metric]
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 10.0,
                                               abs=0.005 + 1e-12)
    assert rec["device"] == "cpu"


def test_jax_bench_has_three_lines():
    assert set(jax_bench_units()) == {"nof_train_steps_per_sec",
                                      "tracking_fps", "pipeline_fps"}


def test_nof_record():
    rec, runner = bench.bench_nof(
        "cpu", repeat=2, H=H, W=W, cfg_overrides=dict(TINY_NERF,
                                                      scan_chunk=2))
    check_record(rec, "nof_train_steps_per_sec")
    # no device timeline on the CPU: no device fields
    assert "device_ms_per_step" not in rec and "util" not in rec
    assert len(rec["repeats"]["value"]) == 2
    assert rec["spread"]["min"] <= rec["value"] <= rec["spread"]["max"]
    # warm-up chunk + 2 repeats x (3 timed runs of 2 chunks)
    assert runner.global_step == 2 + 2 * 3 * 4


def test_nof_roofline_counts_rows_and_bytes():
    runner = bench.nof_workload("cpu", H, W, dict(TINY_NERF, amp=True))
    g, R = runner.spec.grid, runner.tcfg.n_rand
    S = runner.rcfg.n_samples + runner.rcfg.n_samples_around_depth
    m = g.n_levels * R * S * 8
    table = runner.field.table
    want = (m * (4 + 2 * 4 + 2 * 2) + m * (4 + 2 * 2)
            + 7 * table.numel() * 4)
    util = bench.nof_roofline(runner, device_ms=2.0)
    assert util["rows_per_step"] == 2 * m
    assert util["bytes_per_step"] == want
    assert util["bound"] == "hbm-bytes"
    assert util["hbm_bound_ms"] == pytest.approx(want / 3.35e12 * 1e3,
                                                 abs=5e-5)
    assert util["bound_frac"] == pytest.approx(want / 3.35e12 * 1e3 / 2.0,
                                               abs=5e-5)


def test_tracking_record():
    rec, tracker = bench.bench_tracking("cpu", H=H, W=W, n_frames=5,
                                        warmup=2)
    check_record(rec, "tracking_fps")
    for k in ("device_ms_per_frame", "device_fps", "device_ms_by_program",
              "util"):
        assert k not in rec
    assert rec["wall_ms_median"] > 0
    assert {"preprocess", "ba_dispatch"} <= set(rec["wall_stage_ms"])
    assert len(tracker.stage_stats) == 5


def test_pipeline_record_and_floor():
    # 16 frames, 10 steady: the window opens at frame 6, after the first
    # batch (keyframe 5) has dispatched its steps
    rec, tracker = bench.bench_pipeline(
        "cpu", H=H, W=W, n_frames=16, warmup=6, device_ms_per_step=2.0,
        device_ms_per_frame=30.0,
        cfg_nerf_overrides=dict(TINY_NERF, n_step=4),
        cfg_track_overrides=EVERY_FRAME_KEYFRAME)
    check_record(rec, "pipeline_fps")
    for k in ("nof_batches_trained", "nof_steps_trained", "median_fps",
              "mean_fps_full_run", "stalls_s", "final_drain_s",
              "n_sync_blocks"):
        assert k in rec, k
    steps = rec["nof_steps_trained"]
    assert steps > 0 and rec["nof_batches_trained"] >= 1
    assert steps == tracker.pipeline_stats["nof_steps_total"]
    assert tracker.cfg_nerf["sync_max_delay"] == 4
    assert tracker.cfg_nerf["scan_chunk"] == 10
    # the floor covers the steady frames and the steps dispatched while
    # they ran: neither the first batch's steps nor the final drain's
    win = rec["floor_window"]
    assert win["frames"] == 10
    assert 0 < win["nof_steps"] <= steps - 4
    # from the device times given, not bench.py's constants
    floor = 10 / ((win["nof_steps"] * 2.0 + 10 * 30.0) / 1e3)
    assert rec["device_floor_fps_single_chip"] == pytest.approx(
        floor, abs=0.005)
    assert rec["overlap_efficiency"] == pytest.approx(
        rec["value"] / floor, abs=0.5e-4 + 0.005 / floor)
    assert (rec["device_ms_per_step"], rec["device_ms_per_frame"]) == \
        (2.0, 30.0)
    assert all(k.endswith("_s") for k in rec["stalls_s"])


def test_without_cv2_the_tracking_lines_raise(monkeypatch):
    """Without cv2 the tracking lines used to raise; they now get a matcher
    that detects live with the port's ORB, and it detects a frame with cv2
    blocked."""
    from types import SimpleNamespace

    from synthetic import cube_orbit_sequence

    monkeypatch.setitem(sys.modules, "cv2", None)
    seq = cube_orbit_sequence(n_frames=1, H=60, W=80)
    m = bench.orb_matcher(torch.device("cpu"), seq)
    assert m.detector is None
    uv, des = m.detect_features(SimpleNamespace(
        color=seq["colors"][0], fg_mask=seq["masks"][0]))
    assert len(uv) == len(des) > 100 and des.dtype == torch.uint8


def test_replayed_features(tmp_path):
    path = str(tmp_path / "feats.npz")
    rng = np.random.default_rng(0)
    counts = np.array([3, 2], np.int32)
    uv = rng.uniform(0, 50, (5, 2)).astype(np.float32)
    des = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    np.savez(path, counts=counts, uv=uv, des=des)
    m = bench.orb_matcher(torch.device("cpu"), {"id_strs": ["0000", "0001"]},
                          orb_features=path)
    got = m.detector(type("F", (), {"id_str": "0001"})())
    np.testing.assert_array_equal(got[0], uv[3:])
    np.testing.assert_array_equal(got[1], des[3:])


def test_device_label_on_the_cpu():
    assert bench.device_label("cpu") == "cpu"
