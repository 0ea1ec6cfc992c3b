"""The LoFTR matcher's spans and counters, the benchmark's readers of them
and the `custom_loftr.track` cell's driver, on the CPU:

- `find_corres` through a tiny seeded LoFTR (`max_batch` 2, so a call of
  three or more pairs runs several batches) adds one `loftr.pairing` and
  one `loftr.predict` span a call and one `loftr.net` span a batch;
  `loftr.pairs`, `loftr.batches` and `loftr.matches` grow by the call's
  pairs, batches and kept slots;
- under a profiler the spans are `stage:loftr.*` host ranges;
- the three readers on synthetic windows: their defined values, and None
  where the slice holds no `loftr.net` range or counts no pair, and on the
  CPU for the share of the peak;
- the cell's driver end to end at a tiny size (60x80 frames, 96x96
  crops), the matcher built by `BundleSdf` from the checkpoint the driver
  writes: correct at float32 (the net against the float32 reference, the
  frozen tracker on the port's recorded matches), and its replay matcher
  refuses calls whose pairs differ from the recorded ones.
"""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from synthetic import cube_orbit_sequence

from bundlesdf_tpu_torch import bundlesdf
from bundlesdf_tpu_torch.config import default_track_config
from bundlesdf_tpu_torch.matcher import loftr as tl
from bundlesdf_tpu_torch.utils import profiling
from perfbench import harness, loftr_flops, roofline
from perfbench.drivers import track_loftr
from perfbench.tests import tiny
from references import loftr_plain as lp

torch.set_num_threads(2)
TINY = dict(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16, d_fine=8,
            nhead=2, n_coarse_layers=2, n_fine_layers=1, match_thr=0.0,
            max_matches=64)
COUNTERS = ("loftr.pairs", "loftr.batches", "loftr.matches")
SPANS = ("loftr.pairing", "loftr.predict", "loftr.net")


def _counts(snap):
    return {k: snap.get(k, (0, 0.0))[0] for k in SPANS + COUNTERS}


def test_spans_and_counters_of_find_corres(tmp_path):
    cfg = default_track_config()
    cfg["debug_dir"] = str(tmp_path)
    cfg["bundle"]["max_BA_frames"] = 4
    cfg["feature_corres"]["resize"] = 128
    cfg["feature_corres"]["min_match_with_ref"] = 3
    cfg["keyframe"]["min_rot"] = 0
    m = tl.LoftrMatcher(cfg=tl.LoftrConfig(**TINY), device="cpu",
                        max_batch=2)
    t = bundlesdf.BundleSdf(cfg_track=cfg, start_nerf_keyframes=99,
                            matcher=m, device="cpu")
    calls = []
    find, predict = t.find_corres, m.predict

    def predict_spy(a, b):
        out = predict(a, b)
        calls[-1]["kept"] = sum(len(o) for o in out)
        return out

    def find_spy(frame_pairs):
        calls.append({"pairs": len(frame_pairs), "kept": 0,
                      "before": _counts(profiling.snapshot())})
        find(frame_pairs)
        calls[-1]["after"] = _counts(profiling.snapshot())

    m.predict, t.find_corres = predict_spy, find_spy
    seq = cube_orbit_sequence(n_frames=6, H=144, W=192, full_angle=0.15)
    for i in range(6):
        t.run(seq["colors"][i], seq["depths"][i].copy(), seq["K"],
              seq["id_strs"][i], mask=seq["masks"][i])
    t.on_finish()
    matched = [c for c in calls if c["pairs"]]
    assert matched and max(c["pairs"] for c in matched) >= 3
    assert sum(c["kept"] for c in matched) > 0
    for c in calls:
        d = {k: c["after"][k] - c["before"][k] for k in c["after"]}
        n, b = c["pairs"], math.ceil(c["pairs"] / 2)
        assert d == {"loftr.pairing": int(n > 0), "loftr.predict": int(n > 0),
                     "loftr.net": b, "loftr.pairs": n, "loftr.batches": b,
                     "loftr.matches": c["kept"]}, c


def test_spans_are_ranges_under_a_profiler():
    m = tl.LoftrMatcher(cfg=tl.LoftrConfig(**TINY), device="cpu",
                        max_batch=2)
    g = torch.Generator().manual_seed(0)
    imgs = (torch.rand((3, 64, 64), generator=g) * 255).to(torch.uint8)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.predict(imgs, imgs.roll(8, 2))
    names = [e.name for e in prof.events()]
    assert names.count("stage:loftr.predict") == 1
    assert names.count("stage:loftr.net") == 2


def _reader(name):
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": f"stage:{name}",
            "ts": ts, "dur": dur, "args": {}}


def test_readers_on_a_synthetic_window():
    shape = {"cfg": {"initial_dim": 128, "block_dims": [128, 196, 256],
                     "d_coarse": 256, "d_fine": 128, "nhead": 8,
                     "n_coarse_layers": 4, "n_fine_layers": 1,
                     "fine_window": 5, "max_matches": 1024}, "size": 400}
    events = [_range("loftr.pairing", 0, 3000), _range("loftr.predict",
                                                       4000, 40000),
              _range("loftr.net", 5000, 1000), _range("loftr.pairing",
                                                      90000, 2000),
              _range("loftr.predict", 95000, 10000),
              _range("tracker.other", 0, 1e6)]
    window = {"events": events, "trace_units": 2,
              "range_device_ms": {"loftr.net": 50.0, "(outside)": 9.0},
              "loftr_slice": {"loftr.pairs": 10}, "loftr_shape": shape,
              "device_kind": "NVIDIA H100 80GB HBM3"}
    match_ms = _reader("loftr.match_ms.track")
    per_pair = _reader("loftr.device_ms_per_pair.track")
    mfu = _reader("loftr.mfu.track")
    assert match_ms(window) == pytest.approx((3 + 40 + 2 + 10) / 2)
    assert per_pair(window) == pytest.approx(5.0)
    flops = loftr_flops.pair_flops(shape["cfg"], 400, 400)["total"]
    assert mfu(window) == pytest.approx(
        100 * flops * 10 / 0.05 / roofline.PEAK_BF16_FLOPS)
    assert 7 < mfu(window) < 9
    # a program without the spans or counters, and the CPU
    bare = dict(window, events=[_range("tracker.other", 0, 1e6)],
                range_device_ms={"(outside)": 9.0},
                loftr_slice={"loftr.pairs": 0})
    for read in (match_ms, per_pair, mfu):
        assert read(bare) is None
        assert read({}) is None
    assert per_pair(dict(window, loftr_slice={"loftr.pairs": 0})) is None
    assert mfu(dict(window, device_kind="cpu")) is None


def _tiny_cell(tmp, amp):
    """The cell's files at a tiny size: 60x80 frames, 96x96 crops, 3
    warm-up and 2 traced frames; the matcher at @amp."""
    bj, bdir = tiny.make(str(tmp))
    path = os.path.join(bdir, "traffic", "track_loftr.json")
    t = harness.load_json(path)
    t.update({"scene": dict(t["scene"], H=60, W=80), "orbit_frames": 40,
              "warmup_frames": 3, "traced_frames": 2})
    t["track_overrides"] = dict(t["track_overrides"],
                                feature_corres={"resize": 96})
    with open(path, "w") as f:
        json.dump(t, f)
    path = os.path.join(bdir, "configs", "custom_loftr.json")
    c = harness.load_json(path)
    c["matcher"]["amp"] = amp
    with open(path, "w") as f:
        json.dump(c, f)
    return bj, bdir


def test_driver_end_to_end_at_float32(tmp_path):
    bj, bdir = _tiny_cell(tmp_path, amp=False)
    bench, cell = harness.prepare("custom_loftr.track", 2 ** 33 + 5, 1.0,
                                  True, "cpu", benchmark_json=bj,
                                  bench_dir=bdir,
                                  scratch=str(tmp_path / "s"))
    res, err = harness.run_cell(bench, cell, bench_dir=bdir)
    assert res["correct"] is True, err
    assert set(res["compared"]) == {
        "loftr_missed_share", "loftr_uv1_gap_px", "pose_gap_mm",
        "pose_gap_deg"}
    assert res["compared"]["pose_gap_mm"]["value"] == 0.0
    assert res["compared"]["loftr_missed_share"]["value"] == 0.0
    assert res["attempted"] >= 1
    assert "loftr.match_ms.track" in res["metrics"]
    # the device readers read nothing on the CPU
    assert "loftr.device_ms_per_pair.track" not in res["metrics"]
    assert "loftr.mfu.track" not in res["metrics"]
    assert any("matches a pair above 0.2" in line for line in err), err


def test_matcher_is_built_from_the_checkpoint(tmp_path):
    bj, bdir = _tiny_cell(tmp_path, amp=True)
    _, cell = harness.prepare("custom_loftr.track", 3, 0.0, False, "cpu",
                              benchmark_json=bj, bench_dir=bdir,
                              scratch=str(tmp_path / "s"))
    sd = track_loftr.weights(cell)
    tracker = track_loftr.build(cell, sd)
    assert isinstance(tracker.matcher, tl.LoftrMatcher)
    assert tracker.matcher.net.dtype == torch.bfloat16
    assert tracker.matcher.cfg.match_thr == 0.2
    ckpt = tracker.cfg_track["loftr_ckpt"]
    assert ckpt.startswith(str(tmp_path / "s"))
    gains = cell.config["matcher"]["coarse_gain"]
    plain = lp.seeded_state_dict(lp.Config(),
                                 seed=cell.config["matcher"]["seed"])
    for k, g in gains.items():
        assert torch.equal(sd[k], plain[k] * g), k
    # one checkpoint for every run: --seed moves the frames only
    other = track_loftr.weights(harness.prepare(
        "custom_loftr.track", 4, 0.0, False, "cpu", benchmark_json=bj,
        bench_dir=bdir, scratch=str(tmp_path / "t"))[1])
    assert all(torch.equal(other[k], v) for k, v in sd.items())


def test_replay_refuses_other_pairs():
    class F:
        def __init__(self, i):
            self.id = i

    rec = [([(1, 0)], [np.ones((3, 5))]), ([(2, 1), (2, 0)],
                                           [np.ones((2, 5)),
                                            np.zeros((0, 5))])]
    r = track_loftr.Replay(rec)
    out = r.match_frames([(F(1), F(0))])
    assert r.mismatch == 0 and out[0].shape == (3, 5)
    out[0][:] = 7  # a copy: the record stays
    assert rec[0][1][0][0, 0] == 1
    assert r.match_frames([(F(2), F(0))])[0].shape == (0, 5)
    assert r.mismatch == 1
