"""Command line: score HO3D runs (ref `benchmark_ho3d.py:18-207`).

    python -m bundlesdf_tpu_torch.benchmark_ho3d --video_dirs V1,V2 \
        --out_dir RUNS [--log_dir LOG]

Port of the repo's `benchmark_ho3d.py`: for each video, ADD / ADD-S and
their AUCs of the run's `ob_in_cam/*.txt` against the GT poses of the
frames that have one (first-frame aligned), and the Chamfer distance of
the run's last `*mesh_real_world.obj` against the video's
`visible_mesh.ply`, by `eval/benchmark.py::benchmark_video`. The rows go
to `<log_dir>/results.csv`, byte for byte what pandas'
`DataFrame.to_csv(index=False)` writes for them (a NaN is an empty field,
floats as repr, `\\n` line ends), through the csv module: the GPU machine
has no pandas. The JAX script also tries a `results.xlsx` and swallows
its failure; the port does not write one.
"""
from __future__ import annotations

import argparse
import csv
import glob
import math
import os
import tempfile

import numpy as np

from bundlesdf_tpu_torch.datasets import Ho3dReader
from bundlesdf_tpu_torch.eval import benchmark_video
from bundlesdf_tpu_torch.mesh import Mesh


def benchmark_one_video(video_dir, out_dir, method="ours"):
    """The metrics of the run `<out_dir>/<video name>` as
    {"<method>/<video>/<metric>": value}."""
    reader = Ho3dReader(video_dir)
    video_name = reader.get_video_name()
    run_dir = f"{out_dir}/{video_name}"

    gt_poses, ids = [], []
    for i in range(len(reader.color_files)):
        gt = reader.get_gt_pose(i)
        if gt is None:
            continue
        gt_poses.append(gt)
        ids.append(i)
    gt_poses = np.array(gt_poses)

    # GT model cloud: the video's visible_mesh.ply
    gt_model_pts = None
    gt_visible = None
    vm = f"{video_dir}/visible_mesh.ply"
    if os.path.exists(vm):
        m = Mesh.load(vm)
        gt_visible = m.vertices
        gt_model_pts = m.vertices[::max(1, len(m.vertices) // 5000)]
    if gt_model_pts is None:
        raise FileNotFoundError(f"no GT mesh for {video_name}")

    pred_mesh = None
    cands = sorted(glob.glob(f"{run_dir}/**/*mesh_real_world.obj",
                             recursive=True))
    if cands:
        pred_mesh = Mesh.load(cands[-1])

    out = benchmark_video(run_dir, gt_poses, gt_model_pts,
                          gt_visible_pts=gt_visible, pred_mesh=pred_mesh,
                          ids=ids)
    print(f"video {video_name}: " + ", ".join(
        f"{k}={v:.2f}" for k, v in out.items() if np.isfinite(v)))
    return {f"{method}/{video_name}/{k}": v for k, v in out.items()}


def _field(v):
    """A value as pandas writes it in a CSV: NaN empty, floats by repr."""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return v


def write_results_csv(rows: dict, path: str) -> None:
    """{key: value} as the two-column (key, value) CSV pandas writes."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["key", "value"])
        for k, v in rows.items():
            w.writerow([k, _field(v)])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_dirs", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--log_dir", type=str, default="",
                        help="default: a new temporary folder")
    args = parser.parse_args(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    else:
        args.log_dir = tempfile.mkdtemp(prefix="ho3d_bench_")

    rows = {}
    for video_dir in args.video_dirs.split(","):
        rows.update(benchmark_one_video(video_dir, args.out_dir))
    out_csv = os.path.join(args.log_dir, "results.csv")
    write_results_csv(rows, out_csv)
    print(f"saved {out_csv}")
    return rows


if __name__ == "__main__":
    main()
