"""Regenerate the ORB feature fixtures that the GPU runs replay (the card
has no cv2), one file per `--sequence`:

- `orbit30` (default), `tracker_orb_30f.npz`: the ORB features and the JAX
  package's tracked trajectory for the first 30 frames of the 120-frame
  easy orbit at 480x640 (`tests/synthetic.py::cube_orbit_sequence`, depth
  noise 2 mm, seed 0);
- `easy120`, `tracker_orb_easy120.npz`: the whole 120-frame easy orbit of
  `benchmark_synthetic.py --protocol easy` (obj_size 0.08, noise 2 mm, seed
  0), written as a dataset folder by the JAX driver's `write_sequence`; the
  features are detected on what `run_custom.run_one_video` gives the
  tracker (the frames read back, the masks eroded by `erode_mask` 3), and
  the trajectory is the JAX `run_one_video` with the NOF off and no refine
  (`benchmark_synthetic.py --no_nerf --skip_refine`).

    JAX_PLATFORMS=cpu python tests/fixtures/gen_tracker_orb.py \
        [--sequence orbit30|easy120] [--frames 30]

(~2 min and ~1 GB for orbit30, ~10 min for easy120.)

Features come from cv2 as the JAX matcher detects them
(`tests/orb_cv2.py::detect_cv2`: cv2 ORB on the mask crop zoomed to 400
px, FEAT_CAP 2048), checked equal to the JAX matcher's detection on every
frame. The trajectory is the JAX package's tracker-only `BundleSdf.run`
(NOF off, fused matcher, default track config) on the CPU. `chip_smoke.py`
replays the features through `OrbMatcher(detector=...)` and holds the
port's trajectory against the stored one, and holds the port's own
detector (`matcher/orb.py`) against the stored features.

Stored arrays: `counts` (F,) features per frame; `uv` (sum,2) float32 and
`des` (sum,32) uint8, frame after frame; `jax_cam_in_ob` (F,4,4), `jax_status` (F,) FrameStatus values,
`jax_keyframes` frame ids; `model_pts` (20000,3) GT surface samples;
`jax_add`/`jax_adds` (F,) per-frame ADD/ADD-S in meters after first-frame
alignment.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(HERE))

OUTS = {"orbit30": "tracker_orb_30f.npz", "easy120": "tracker_orb_easy120.npz"}


def orbit_frames(n_frames=30):
    """The card run's frames: the first @n_frames of the 120-frame orbit."""
    from synthetic import cube_orbit_sequence
    return cube_orbit_sequence(n_frames=n_frames, H=480, W=640, radius=0.45,
                               obj_size=0.08,
                               full_angle=2 * np.pi * n_frames / 120,
                               noise=0.002, seed=0)


def tracker_inputs(sequence, n_frames, tmp):
    """The first @n_frames of @sequence and the (colors, masks) its
    fixture's features are detected on; easy120's frames go through a
    dataset folder under @tmp."""
    seq = orbit_frames(n_frames)
    if sequence != "easy120":
        return seq, seq["colors"], seq["masks"]
    from bundlesdf_tpu_torch.benchmark_synthetic import write_dataset
    write_dataset(tmp, seq)
    return (seq,) + driver_inputs(tmp)


def detect_all(colors, masks):
    """cv2's detection (the JAX matcher's) on each (color, mask) as the
    tracker's Frame holds them (`fg_mask` = mask > 0)."""
    from orb_cv2 import detect_cv2
    return [detect_cv2(c, (m > 0).astype(np.uint8))
            for c, m in zip(colors, masks)]


def driver_inputs(video_dir, erode=3):
    """(colors, masks) as the port's `run_one_video` hands them to the
    tracker: read back through `YcbineoatReader`, masks eroded."""
    from bundlesdf_tpu_torch.datasets import YcbineoatReader
    from bundlesdf_tpu_torch.run_custom import erode_mask
    reader = YcbineoatReader(video_dir=video_dir, shorter_side=480)
    n = len(reader.color_files)
    return ([reader.get_color(i) for i in range(n)],
            [erode_mask(reader.get_mask(i), erode) for i in range(n)])


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


def run_jax_driver(video_dir, out_folder):
    """The JAX `benchmark_synthetic.py --no_nerf --skip_refine` run:
    `run_custom.run_one_video` on the dataset folder with a JAX ORB
    matcher whose cache keeps every frame's detection."""
    from bundlesdf_tpu.matcher import OrbMatcher
    from run_custom import run_one_video
    from benchmark_synthetic import collect_frame_statuses
    matcher = OrbMatcher()
    t0 = time.perf_counter()
    run_one_video(video_dir, out_folder, stride=1, debug_level=1,
                  refine_overrides={"n_step": 2000}, skip_refine=True,
                  start_nerf_keyframes=10 ** 9, matcher=matcher)
    print(f"jax driver: {time.perf_counter() - t0:.1f} s", flush=True)
    ids = sorted(os.path.basename(f)[:-4] for f in os.listdir(
        os.path.join(video_dir, "rgb")))
    ob_in_cam = np.array([np.loadtxt(os.path.join(
        out_folder, "ob_in_cam", f"{i}.txt")) for i in ids])
    from bundlesdf_tpu.tracker.frame import FrameStatus
    status = np.array([FrameStatus[s].value for s in
                       collect_frame_statuses(out_folder, ids)], np.int32)
    stamps = sorted(d for d in os.listdir(out_folder) if os.path.exists(
        os.path.join(out_folder, d, "keyframes.yml")))
    import yaml
    with open(os.path.join(out_folder, stamps[-1], "keyframes.yml")) as f:
        kf_ids = sorted(yaml.safe_load(f))
    kfs = np.array([ids.index(k) for k in kf_ids], np.int32)
    uv_jax = [matcher._cache[i][0] for i in range(len(ids))]
    return np.linalg.inv(ob_in_cam), status, kfs, uv_jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", default="orbit30", choices=sorted(OUTS))
    ap.add_argument("--frames", type=int, default=30,
                    help="frames of the orbit30 sequence")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    out = args.out or os.path.join(HERE, OUTS[args.sequence])
    import jax
    jax.config.update("jax_platforms", "cpu")
    from benchmark_synthetic import gt_surface_points, write_sequence

    tmp = tempfile.mkdtemp()
    try:
        if args.sequence == "easy120":
            video_dir = os.path.join(tmp, "video")
            seq = write_sequence(video_dir, 120, 480, 640, 0.002,
                                 protocol="easy")
            colors, masks = driver_inputs(video_dir)
            poses, status, kfs, uv_jax = run_jax_driver(
                video_dir, os.path.join(tmp, "run"))
        else:
            seq = orbit_frames(args.frames)
            colors, masks = seq["colors"], seq["masks"]
            poses, status, kfs, uv_jax = run_jax(seq)
        feats = detect_all(colors, masks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for i, ((uv, _), uj) in enumerate(zip(feats, uv_jax)):
        assert np.array_equal(uv, np.asarray(uj, np.float32)), \
            f"frame {i}: port and JAX detection differ"
    arrays = dict(
        counts=np.array([len(u) for u, _ in feats], np.int32),
        uv=np.concatenate([u for u, _ in feats]).astype(np.float32),
        des=np.concatenate([d for _, d in feats]).astype(np.uint8))
    model_pts = gt_surface_points(20000).astype(np.float32)
    add, adds = pose_errors(poses, seq["cam_in_obs"], model_pts)
    arrays.update(jax_cam_in_ob=poses, jax_status=status,
                  jax_keyframes=kfs, model_pts=model_pts, jax_add=add,
                  jax_adds=adds)
    msg = (f", FAIL {int((status == 0).sum())}, keyframes {len(kfs)}, "
           f"mean ADD {add.mean() * 1e3:.3f} mm, ADD-S "
           f"{adds.mean() * 1e3:.3f} mm")
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {len(feats)} frames, features/frame "
          f"{min(map(len, uv_jax))}-{max(map(len, uv_jax))}{msg}")


if __name__ == "__main__":
    main()
