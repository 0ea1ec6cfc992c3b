"""One-off CPU check of the offline refine against the JAX package.

    JAX_PLATFORMS=cpu python tests/refine_vs_jax.py [--steps 200] \
        [--seeds 0 1] [--frames 30] [--out DIR]
    python tests/refine_vs_jax.py --score OUT    # no JAX, runs on the card

Both packages' `BundleSdf.run_global_nerf` run on one artifact folder:
the JAX package's tracker-only `run_custom.run_one_video` (`SPDLOG` 1, the
NOF off) over the first @frames frames of the 480x640 easy orbit (depth
noise 2 mm, seed 0), as the GPU smoke run's refine phase uses them. The
refine config is `run_one_video_global_nerf`'s with the `--quick`
overrides of `benchmark_synthetic.py` (6 levels, finest 128, 64 + 64
samples, mesh at 0.004) and `n_step` @steps. For each seed the JAX runner
is built with that seed (its initial weights and its batch draws) and the
port's runner starts from the same initial weights (`params_from_jax`),
its own draws seeded alike. Printed, one JSON line a run: the loss curve
(every 10th step), the keyframes' mean ADD / ADD-S before the refine (the
online poses of `keyframes.yml`) and after (`optimized_poses.txt`), and
the refined mesh's Chamfer against the GT surface the frames saw, all by
`eval/benchmark.py`. The last line compares the stacks: each metric's
mean per stack, and its seed-to-seed spread (max - min) per stack, the
tolerance of the comparison. Takes ~30 min and ~6 GB on 8 cores.

`--score OUT` scores the keyframes of a `benchmark_synthetic` run in OUT
the same way (before and after its refine) and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

QUICK = dict(num_levels=6, finest_res=128, N_samples_around_depth=64,
             n_train_image=60, mesh_resolution=0.004)


def make_artifacts(root, n_frames):
    """The JAX tracker-only online run's artifact folder; returns (folder,
    sequence)."""
    from bundlesdf_tpu_torch.benchmark_synthetic import write_dataset
    from run_custom import run_one_video
    from fixtures.gen_tracker_orb import orbit_frames
    seq = orbit_frames(n_frames)
    video = os.path.join(root, "video")
    write_dataset(video, seq)
    out = os.path.join(root, "run")
    run_one_video(video, out, debug_level=1, skip_refine=True,
                  start_nerf_keyframes=10 ** 9)
    return out, seq


def refine_config(folder, steps):
    from bundlesdf_tpu_torch.config import (default_nerf_config,
                                            default_track_config,
                                            load_config)
    from bundlesdf_tpu_torch.run_custom import REFINE_CONFIG
    cfg_track = load_config(f"{folder}/config_bundletrack.yml",
                            default_track_config())
    cfg_track["debug_dir"] = folder + "/"
    cfg_nerf = load_config(f"{folder}/config_nerf.yml",
                           default_nerf_config())
    cfg_nerf.update(REFINE_CONFIG)
    cfg_nerf.update(QUICK)
    cfg_nerf["n_step"] = steps
    return cfg_track, cfg_nerf


class Runs:
    """Builds each package's NofRunner with the run's seed; the port's
    starts from the weights the JAX runner of the same seed drew."""

    def __init__(self):
        self.seed = 0
        self.jax_init = {}
        self.runner = None

    def patch(self):
        import bundlesdf_tpu.bundlesdf as jb
        import bundlesdf_tpu_torch.bundlesdf as tb
        import jax
        import torch
        from bundlesdf_tpu_torch.nof.models import params_from_jax
        runs = self

        class JaxRunner(jb.NofRunner):
            def __init__(self, *a, **k):
                super().__init__(*a, seed=runs.seed, **k)
                runs.jax_init[runs.seed] = jax.tree.map(np.asarray,
                                                        self.params)
                runs.runner = self

        class PortRunner(tb.NofRunner):
            def __init__(self, *a, **k):
                super().__init__(*a, seed=runs.seed, **k)
                p = dict(runs.jax_init[runs.seed])
                F = self.spec.n_frames
                for key in ("pose_array", "feature_array"):
                    if key in p:
                        p[key] = p[key][:F]   # the JAX frame bucket
                with torch.no_grad():
                    self.field.load_state_dict(params_from_jax(p))
                runs.runner = self

        jb.NofRunner = JaxRunner
        tb.NofRunner = PortRunner


def keyframe_scores(folder, seq, out_dir, mesh):
    from bundlesdf_tpu_torch.config import load_yaml
    from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
    from bundlesdf_tpu_torch.benchmark_synthetic import gt_surface_points
    stamps = sorted(d for d in os.listdir(folder) if os.path.exists(
        os.path.join(folder, d, "keyframes.yml")))
    reg = load_yaml(os.path.join(folder, stamps[-1], "keyframes.yml"))
    ids = sorted(reg)
    idx = [seq["id_strs"].index(i) for i in ids]
    gt = np.linalg.inv(seq["cam_in_obs"][idx])
    before = np.array([np.reshape(reg[i]["cam_in_ob"], (4, 4)) for i in ids])
    after = np.loadtxt(os.path.join(out_dir, "optimized_poses.txt")) \
        .reshape(-1, 4, 4)
    mp = gt_surface_points(20000)
    # the GT surface the frames saw (chip_smoke.visible_gt_points)
    from scipy.spatial import cKDTree
    from bundlesdf_tpu_torch.utils.common import depth2xyzmap
    pts = []
    for i in range(len(seq["depths"])):
        d = seq["depths"][i].astype(np.float64)
        xyz = depth2xyzmap(d, seq["K"])[(d >= 0.1) & (seq["masks"][i] > 0)]
        T = seq["cam_in_obs"][i]
        pts.append(xyz[::4] @ T[:3, :3].T + T[:3, 3])
    dist, _ = cKDTree(np.concatenate(pts)).query(mp, k=1)
    vis = mp[dist < 0.005]
    s0 = benchmark_video(None, gt, mp, vis, pred_poses=np.linalg.inv(before))
    s1 = benchmark_video(None, gt, mp, vis, pred_poses=np.linalg.inv(after),
                         pred_mesh=mesh)
    return {"keyframes": len(ids),
            "kf_add_mm_before": s0["ADD(cm)"] * 10,
            "kf_add_mm_after": s1["ADD(cm)"] * 10,
            "kf_adds_mm_before": s0["ADDS(cm)"] * 10,
            "kf_adds_mm_after": s1["ADDS(cm)"] * 10,
            "chamfer_cm": s1["chamfer(cm)"]}


def score_driver_folder(out):
    """Keyframe scores before and after the refine of a
    `benchmark_synthetic` out folder (`video/` and `run/`), the ground
    truth read from its dataset folder."""
    from bundlesdf_tpu_torch.datasets import YcbineoatReader
    from bundlesdf_tpu_torch.mesh import Mesh
    r = YcbineoatReader(os.path.join(out, "video"))
    n = len(r.color_files)
    seq = {"depths": np.array([r.get_depth(i) for i in range(n)]),
           "masks": np.array([r.get_mask(i) for i in range(n)]),
           "K": r.K, "id_strs": r.id_strs,
           "cam_in_obs": np.array([np.linalg.inv(np.loadtxt(os.path.join(
               out, "video", "annotated_poses", f"{i}.txt")))
               for i in r.id_strs])}
    run = os.path.join(out, "run")
    nerf = os.path.join(run, "nerf_with_bundletrack_online")
    mesh = Mesh.load(os.path.join(nerf, "mesh_real_world.obj"))
    return keyframe_scores(run, seq, nerf, mesh)


def run_one(stack, folder, seq, steps, runs, root):
    import bundlesdf_tpu.bundlesdf as jb
    import bundlesdf_tpu_torch.bundlesdf as tb
    cfg_track, cfg_nerf = refine_config(folder, steps)
    out_dir = os.path.join(root, f"{stack}_seed{runs.seed}")
    t0 = time.perf_counter()
    if stack == "jax":
        t = jb.BundleSdf(cfg_track=cfg_track, cfg_nerf=cfg_nerf)
    else:
        t = tb.BundleSdf(cfg_track=cfg_track, cfg_nerf=cfg_nerf,
                         device="cpu")
    losses = []
    train = runs_train_hook(losses)
    with train:
        t.run_global_nerf(get_texture=False, out_dir=out_dir)
    rec = {"stack": stack, "seed": runs.seed, "steps": len(losses),
           "seconds": round(time.perf_counter() - t0, 1),
           "loss_every_10": [round(float(x), 5) for x in losses[::10]],
           "loss_last_10_mean": float(np.mean(losses[-10:]))}
    rec.update(keyframe_scores(folder, seq, out_dir, t.mesh))
    return rec


class runs_train_hook:
    """Collect every training step's loss from both packages'
    `NofRunner.train`."""

    def __init__(self, losses):
        self.losses = losses

    def __enter__(self):
        import bundlesdf_tpu.nof.runner as jr
        import bundlesdf_tpu_torch.nof.runner as tr
        self.saved = (jr.NofRunner.train, tr.NofRunner.train)
        losses = self.losses

        def wrap(orig):
            def train(self, n_steps=None):
                m = orig(self, n_steps)
                losses.extend(np.asarray(m["loss"]).tolist())
                return m
            return train

        jr.NofRunner.train = wrap(self.saved[0])
        tr.NofRunner.train = wrap(self.saved[1])
        return self

    def __exit__(self, *exc):
        import bundlesdf_tpu.nof.runner as jr
        import bundlesdf_tpu_torch.nof.runner as tr
        jr.NofRunner.train, tr.NofRunner.train = self.saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default="")
    ap.add_argument("--score", default="",
                    help="only score a benchmark_synthetic out folder's "
                         "keyframes before and after its refine (no JAX)")
    args = ap.parse_args()
    if args.score:
        print(json.dumps(score_driver_folder(args.score)), flush=True)
        return
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(4)

    root = args.out or tempfile.mkdtemp(prefix="refine_vs_jax_")
    try:
        folder, seq = make_artifacts(root, args.frames)
        runs = Runs()
        runs.patch()
        recs = []
        for seed in args.seeds:
            runs.seed = seed
            for stack in ("jax", "port"):
                rec = run_one(stack, folder, seq, args.steps, runs, root)
                print(json.dumps(rec), flush=True)
                recs.append(rec)
        keys = ("loss_last_10_mean", "kf_add_mm_before", "kf_add_mm_after",
                "kf_adds_mm_after", "chamfer_cm")
        summary = {}
        for stack in ("jax", "port"):
            rs = [r for r in recs if r["stack"] == stack]
            summary[stack] = {k: {"mean": float(np.mean([r[k] for r in rs])),
                                  "seed_spread": float(np.ptp(
                                      [r[k] for r in rs]))} for k in keys}
        print(json.dumps({"summary": summary}), flush=True)
    finally:
        if not args.out:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
