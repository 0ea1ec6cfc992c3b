"""A copy of the benchmark's files at a size a CPU test can hold: the
configurations, mixes, limits and metric readers of `perfbench/`, with
each mix cut (small frames, few keyframes, a small NOF) and a
`BENCHMARK.json` of its own."""
from __future__ import annotations

import copy
import json
import os
import shutil

from perfbench import harness

TINY_SCENE = {"H": 60, "W": 80}
TINY_NERF = {"N_rand": 64, "N_samples": 8, "N_samples_around_depth": 8,
             "num_levels": 4, "finest_res": 32, "log2_hashmap_size": 12,
             "n_step": 20}
TINY = {
    "refine_40kf": {"keyframes": 6, "traced_steps": 2,
                    "scene": TINY_SCENE, "refine_overrides": TINY_NERF},
    "online_strict": {"scene": TINY_SCENE, "orbit_frames": 40,
                      "nerf_overrides": dict(TINY_NERF, n_step=10)},
    "track_only": {"scene": TINY_SCENE, "orbit_frames": 40,
                   "warmup_frames": 3, "traced_frames": 2},
}


def make(tmp, limits=None, traffic_tweaks=None):
    """A benchmark directory under @tmp with tiny mixes; returns
    (BENCHMARK.json path, benchmark directory). @limits:
    {cell: {number: limit}} overriding the limit files."""
    src = harness.HERE
    bdir = os.path.join(tmp, "bench")
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(src, sub), os.path.join(bdir, sub))
    for name, tweak in TINY.items():
        path = os.path.join(bdir, "traffic", f"{name}.json")
        t = harness.load_json(path)
        for k, v in tweak.items():
            t[k] = dict(t.get(k, {}), **v) if isinstance(v, dict) else v
        for k, v in (traffic_tweaks or {}).get(name, {}).items():
            t[k] = v
        with open(path, "w") as f:
            json.dump(t, f)
    bench = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    bench = copy.deepcopy(bench)
    for cell, lim in (limits or {}).items():
        with open(os.path.join(bdir, "limits", f"{cell}.json"), "w") as f:
            json.dump(lim, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path, bdir


def run(tmp, workload, seed=1, seconds=0.5, trace=False, limits=None,
        traffic_tweaks=None):
    """One tiny run of @workload on the CPU: (result line, stderr lines)."""
    bj, bdir = make(tmp, limits, traffic_tweaks)
    bench, cell = harness.prepare(workload, seed, seconds, trace, "cpu",
                                  benchmark_json=bj, bench_dir=bdir,
                                  scratch=os.path.join(tmp, "scratch"))
    return harness.run_cell(bench, cell, bench_dir=bdir)
