"""Regenerate `tests/fixtures/tracker_orb_30f.npz`: the ORB features and the
JAX package's tracked trajectory for the first 30 frames of the 120-frame
easy orbit at 480x640 (`tests/synthetic.py::cube_orbit_sequence`, depth
noise 2 mm, seed 0).

    JAX_PLATFORMS=cpu python tests/fixtures/gen_tracker_orb.py [--frames 30]

Features come from the port's own host detection
(`bundlesdf_tpu_torch.matcher.classical.OrbMatcher.detect_features`: cv2
ORB on the mask crop zoomed to 400 px, FEAT_CAP 2048), checked equal to
the JAX matcher's detection on every frame. The trajectory is the JAX
package's tracker-only `BundleSdf.run` (NOF off, fused matcher, default
track config) on the CPU. `chip_smoke.py` replays the features through
`OrbMatcher(detector=...)` on a machine without cv2 and holds the port's
trajectory against the stored one.

Stored arrays: `counts` (F,) features per frame; `uv` (sum,2) float32 and
`des` (sum,32) uint8, frame after frame; `jax_cam_in_ob` (F,4,4),
`jax_status` (F,) FrameStatus values, `jax_keyframes` frame ids;
`model_pts` (20000,3) GT surface samples; `jax_add`/`jax_adds` (F,)
per-frame ADD/ADD-S in meters after first-frame alignment.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(HERE))

OUT = os.path.join(HERE, "tracker_orb_30f.npz")


def orbit_frames(n_frames=30):
    """The card run's frames: the first @n_frames of the 120-frame orbit."""
    from synthetic import cube_orbit_sequence
    return cube_orbit_sequence(n_frames=n_frames, H=480, W=640, radius=0.45,
                               obj_size=0.08,
                               full_angle=2 * np.pi * n_frames / 120,
                               noise=0.002, seed=0)


def detect_all(seq):
    from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
    orb = OrbMatcher(device="cpu")
    feats = []
    for c, m in zip(seq["colors"], seq["masks"]):
        fr = SimpleNamespace(color=c, fg_mask=(m > 0).astype(np.uint8))
        feats.append(orb.detect_features(fr))
    return feats


def pose_errors(cam_in_ob, gt_cam_in_ob, model_pts):
    """Per-frame ADD / ADD-S (m) after first-frame alignment, the
    benchmark harness's protocol (benchmark_ho3d.py:62)."""
    from bundlesdf_tpu_torch.eval.metrics import add_err, adi_err
    pred = np.linalg.inv(cam_in_ob)
    gt = np.linalg.inv(gt_cam_in_ob)
    pred = pred @ np.linalg.inv(pred[0]) @ gt[0]
    add = np.array([add_err(p, g, model_pts) for p, g in zip(pred, gt)])
    adds = np.array([adi_err(p, g, model_pts) for p, g in zip(pred, gt)])
    return add, adds


def run_jax(seq):
    from bundlesdf_tpu.bundlesdf import BundleSdf
    from bundlesdf_tpu.config import default_nerf_config, default_track_config
    from bundlesdf_tpu.matcher import OrbMatcher

    tmp = tempfile.mkdtemp()
    try:
        cfg = default_track_config()
        cfg.update(SPDLOG=0, stage_timing=True, debug_dir=tmp)
        cfg["feature_corres"]["fused_matcher"] = True
        matcher = OrbMatcher()
        t = BundleSdf(cfg_track=cfg, cfg_nerf=default_nerf_config(),
                      start_nerf_keyframes=10 ** 9, matcher=matcher)
        frames = []
        for i in range(len(seq["colors"])):
            t0 = time.perf_counter()
            frames.append(t.run(seq["colors"][i], seq["depths"][i].copy(),
                                seq["K"], seq["id_strs"][i],
                                mask=seq["masks"][i]))
            print(f"jax frame {i}: {time.perf_counter() - t0:.2f} s",
                  flush=True)
        t.flush_pipeline()
        uv_jax = [matcher._cache[f.id][0] for f in frames]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return (np.array([f.pose_in_model for f in frames]),
            np.array([f.status.value for f in frames], np.int32),
            np.array([kf.id for kf in t.bundler.keyframes], np.int32), uv_jax)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from benchmark_synthetic import gt_surface_points

    seq = orbit_frames(args.frames)
    feats = detect_all(seq)
    poses, status, kfs, uv_jax = run_jax(seq)
    for i, ((uv, _), uj) in enumerate(zip(feats, uv_jax)):
        assert np.array_equal(uv, np.asarray(uj, np.float32)), \
            f"frame {i}: port and JAX detection differ"
    model_pts = gt_surface_points(20000).astype(np.float32)
    add, adds = pose_errors(poses, seq["cam_in_obs"], model_pts)
    np.savez_compressed(
        args.out,
        counts=np.array([len(u) for u, _ in feats], np.int32),
        uv=np.concatenate([u for u, _ in feats]).astype(np.float32),
        des=np.concatenate([d for _, d in feats]).astype(np.uint8),
        jax_cam_in_ob=poses, jax_status=status, jax_keyframes=kfs,
        model_pts=model_pts, jax_add=add, jax_adds=adds)
    print(f"wrote {args.out}: features/frame {min(map(len, uv_jax))}-"
          f"{max(map(len, uv_jax))}, FAIL {int((status == 0).sum())}, "
          f"keyframes {len(kfs)}, mean ADD {add.mean() * 1e3:.3f} mm, "
          f"ADD-S {adds.mean() * 1e3:.3f} mm")


if __name__ == "__main__":
    main()
