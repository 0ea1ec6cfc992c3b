"""The harness finds a configuration, a traffic mix and a per-layer metric
added as files alone, by the names BENCHMARK.json gives them."""
import json
import os
import shutil

from perfbench import harness
from perfbench.tests import tiny


def test_added_files_are_found(tmp_path):
    bj, bdir = tiny.make(str(tmp_path))
    shutil.copy(os.path.join(bdir, "configs", "custom.json"),
                os.path.join(bdir, "configs", "custom_copy.json"))
    t = harness.load_json(os.path.join(bdir, "traffic", "track_only.json"))
    t["warmup_frames"] = 2
    with open(os.path.join(bdir, "traffic", "track_short.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(bdir, "metrics", "extra.frames.py"), "w") as f:
        f.write("def read(window):\n    return window.get('frames')\n")
    with open(os.path.join(bdir, "metrics", "extra.silent.py"), "w") as f:
        f.write("def read(window):\n    return None\n")
    with open(os.path.join(bdir, "limits", "copy.track.json"), "w") as f:
        json.dump({"pose_gap_mm": 1e-3, "pose_gap_deg": 1e-3}, f)
    bench = harness.load_json(bj)
    bench["configs"].append(dict(bench["configs"][0], name="custom_copy",
                                 file="perfbench/configs/custom_copy.json"))
    bench["workloads"].append({"name": "copy.track", "config": "custom_copy",
                               "traffic": "track_short", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in ("extra.frames", "extra.silent"):
        bench["per_layer"].append({
            "name": m, "unit": "frames", "better": "higher",
            "source": "program_counter", "layer": "tracker",
            "moves": "frames_per_s", "workloads": ["copy.track"]})
    bench["end_to_end"][0]["workloads"].append("copy.track")
    with open(bj, "w") as f:
        json.dump(bench, f)
    b, cell = harness.prepare("copy.track", 3, 0.3, True, "cpu",
                              benchmark_json=bj, bench_dir=bdir,
                              scratch=str(tmp_path / "s"))
    assert cell.traffic["warmup_frames"] == 2
    res, err = harness.run_cell(b, cell, bench_dir=bdir)
    assert res["metrics"]["extra.frames"]["value"] >= 1
    assert "extra.silent" not in res["metrics"]
    assert set(res["metrics"]) == {"extra.frames"}
    assert res["correct"] is True
    assert list(res)[-1] == "compared"
    assert err[-2:] == [f"{k} {v['value']!r} limit {v['limit']!r}"
                        for k, v in res["compared"].items()]
