"""End-to-end benchmark of the port on a full-resolution textured synthetic
sequence.

    python -m bundlesdf_tpu_torch.benchmark_synthetic --out OUT \
        [--protocol easy|occluder|translation] [--n_frames 120] \
        [--H 480 --W 640] [--noise 0.002] [--refine_steps 2000] [--quick] \
        [--device cuda] [--orb_features tests/fixtures/tracker_orb_easy120.npz]

Port of the repo's `benchmark_synthetic.py`, with its protocols, flags,
`metrics.json` keys and FAIL / recovery accounting. It writes a 480x640
textured cube-cluster sequence with depth noise to disk in YCBInEOAT
layout (PNGs through `utils/png.py`), runs the port's
`run_custom.run_one_video` on it (online tracking with the NOF, then the
offline refine), and scores ADD/ADD-S AUC and the mesh Chamfer against
the analytic ground truth with `eval/benchmark.py::benchmark_video`, the
first-frame-align + ICP protocol of the reference's
`benchmark_ho3d.py:18-139`.

Differences from the JAX driver:
- `--device` (the card unless `cpu`) replaces `--platform`;
- ORB features are detected live by the port's own detector
  (`matcher/orb.py`); `--orb_features PATH` replays stored ones instead
  (`tests/fixtures/gen_tracker_orb.py --sequence easy120` writes cv2's for
  the 120-frame easy run);
- `--track_override` values are read without PyYAML, to what
  `yaml.safe_load` gives, and forms beyond null, bools, decimal numbers,
  strings and flat lists are refused (`config.parse_yaml_value`);
- with `--stride` > 1 the frame statuses are those of the strided frames,
  aligned with the strided poses.

Writes `<out>/metrics.json` and prints the metrics; with `--report FILE`
also appends a markdown row there. Without `--out` the run goes to a new
temporary folder; an `--out` whose `run/` already holds poses or a mesh
is refused unless `--skip_run` asks to score them.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

from bundlesdf_tpu_torch.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synthetic():
    """The repo's synthetic sequences (`tests/synthetic.py`, pure numpy)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import synthetic as syn
    return syn


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


# the box cluster rendered by cube_orbit_sequence (tests/synthetic.py)
def _gt_boxes(s):
    return [
        ((0, 0, 0), (s, s, s)),
        ((s * 0.9, 0, s * 0.9), (s * 0.45, s * 0.45, s * 0.45)),
        ((-s * 0.8, s * 0.7, 0), (s * 0.35, s * 0.35, s * 0.35)),
    ]


def _box_mesh(center, half):
    c = np.asarray(center, np.float64)
    h = np.asarray(half, np.float64)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64) * h + c
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x- x+
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y- y+
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z- z+
    ], np.int64)
    return corners, faces


def gt_mesh(obj_size=0.08) -> Mesh:
    verts, faces = [], []
    off = 0
    for center, half in _gt_boxes(obj_size):
        v, f = _box_mesh(center, half)
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return Mesh(np.concatenate(verts), np.concatenate(faces))


def gt_surface_points(n=40000, obj_size=0.08, seed=0):
    """Sample the union surface: points on any box's surface that are not
    strictly inside another box."""
    m = gt_mesh(obj_size)
    pts = m.sample_surface(n, seed=seed)
    keep = np.ones(len(pts), bool)
    for center, half in _gt_boxes(obj_size):
        c = np.asarray(center)
        h = np.asarray(half)
        inside = (np.abs(pts - c) < h - 1e-6).all(axis=-1)
        keep &= ~inside
    return pts[keep]


def write_sequence(video_dir, n_frames, H, W, noise, obj_size=0.08,
                   protocol="easy"):
    """Render the protocol's sequence and write it to @video_dir
    (`write_dataset`). Returns the sequence."""
    syn = synthetic()
    if protocol == "translation":
        # translation-dominant stress geometry: a lateral slide at fixed
        # orientation
        seq = syn.cube_translation_sequence(n_frames=n_frames, H=H, W=W,
                                            obj_size=obj_size, noise=noise)
    else:
        seq = syn.cube_orbit_sequence(n_frames=n_frames, H=H, W=W,
                                      radius=0.45, obj_size=obj_size,
                                      noise=noise)
    if protocol == "occluder":
        seq = syn.add_occluder(seq)
    write_dataset(video_dir, seq)
    return seq


def write_dataset(video_dir, seq):
    """@seq as a YCBInEOAT folder: rgb/, depth/ (uint16 mm), masks/
    (0/255), masks_hand/ where it has occluder masks, annotated_poses/
    and cam_K.txt, every image through `utils/png.py`."""
    from bundlesdf_tpu_torch.utils.png import write_png
    subs = ["rgb", "depth", "masks", "annotated_poses"]
    if "occ_masks" in seq:
        subs.append("masks_hand")
    for sub in subs:
        os.makedirs(os.path.join(video_dir, sub), exist_ok=True)
    np.savetxt(os.path.join(video_dir, "cam_K.txt"), seq["K"])
    for i, id_str in enumerate(seq["id_strs"]):
        write_png(f"{video_dir}/rgb/{id_str}.png", seq["colors"][i])
        write_png(f"{video_dir}/depth/{id_str}.png",
                  np.round(seq["depths"][i] * 1000).astype(np.uint16))
        write_png(f"{video_dir}/masks/{id_str}.png",
                  (seq["masks"][i] * 255).astype(np.uint8))
        if "occ_masks" in seq:
            write_png(f"{video_dir}/masks_hand/{id_str}.png",
                      (seq["occ_masks"][i] * 255).astype(np.uint8))
        np.savetxt(f"{video_dir}/annotated_poses/{id_str}.txt",
                   np.linalg.inv(seq["cam_in_obs"][i]))


def collect_frame_statuses(out_folder, id_strs):
    """Per-frame status from the run's frame.txt dumps (FAIL cascade +
    recovery accounting for the occluder protocol)."""
    statuses = []
    for id_str in id_strs:
        p = os.path.join(out_folder, id_str, "frame.txt")
        status = "MISSING"
        if os.path.exists(p):
            with open(p) as f:
                for line in f:
                    if line.startswith("status:"):
                        status = line.split(":", 1)[1].strip()
        statuses.append(status)
    return statuses


def parse_track_overrides(items) -> dict:
    """{dotted.key: value} from `dotted.key=value` strings, each value
    read as `yaml.safe_load` reads it."""
    from bundlesdf_tpu_torch.config import parse_yaml_value
    out = {}
    for item in items:
        key, _, val = item.partition("=")
        out[key] = parse_yaml_value(val)
    return out


def score(out_folder, seq, stride, protocol):
    """The metrics of a run folder: `benchmark_video` against the ground
    truth, then the FAIL / recovery accounting over the strided frames."""
    from bundlesdf_tpu_torch.eval.benchmark import benchmark_video
    from bundlesdf_tpu_torch.eval.metrics import add_err
    gt_poses = np.linalg.inv(seq["cam_in_obs"])[::stride]
    model_pts = gt_surface_points(20000)
    visible_pts = gt_surface_points(60000, seed=1)
    mesh_path = os.path.join(out_folder, "textured_mesh.obj")
    if not os.path.exists(mesh_path):
        mesh_path = os.path.join(out_folder, "nerf_with_bundletrack_online",
                                 "mesh_real_world.obj")
    pred_mesh = Mesh.load(mesh_path) if os.path.exists(mesh_path) else None

    metrics = benchmark_video(out_folder, gt_poses, model_pts,
                              gt_visible_pts=visible_pts,
                              pred_mesh=pred_mesh)
    # FAIL/recovery accounting rides every protocol's record
    statuses = collect_frame_statuses(out_folder, seq["id_strs"][::stride])
    n_fail = sum(s == "FAIL" for s in statuses)
    metrics["fail_frames"] = n_fail
    if protocol == "occluder" or n_fail:
        # recovered = tracking resumed OK after the last FAIL frame
        last_fail = max((i for i, s in enumerate(statuses) if s == "FAIL"),
                        default=-1)
        post = statuses[last_fail + 1:]
        metrics["recovered"] = bool(last_fail >= 0 and post
                                    and all(s != "FAIL" for s in post))
        # pose error over the post-recovery tail (re-localization against
        # the keyframe pool, ref bundlesdf.py:443-465)
        pose_files = sorted(glob.glob(f"{out_folder}/ob_in_cam/*.txt"))
        pred = np.array([np.loadtxt(f) for f in pose_files])
        pred = pred @ np.linalg.inv(pred[0]) @ gt_poses[0]
        tail = slice(last_fail + 1, None)
        errs = [add_err(p, g, model_pts) for p, g in
                zip(pred[tail], gt_poses[tail])]
        metrics["ADD_post_recovery(cm)"] = float(np.mean(errs) * 100)
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="",
                    help="output folder (default: a new temporary folder)")
    ap.add_argument("--n_frames", type=int, default=120)
    ap.add_argument("--H", type=int, default=480)
    ap.add_argument("--W", type=int, default=640)
    ap.add_argument("--noise", type=float, default=0.002)
    ap.add_argument("--protocol", default="easy",
                    choices=["easy", "occluder", "translation"],
                    help="occluder: moving occluder sweep with occ_masks, "
                         "forcing FAIL frames + relocalization; "
                         "translation: lateral slide at fixed orientation "
                         "(translation-dominant stress geometry)")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--refine_steps", type=int, default=2000)
    ap.add_argument("--online_steps", type=int, default=0,
                    help="override online NOF n_step (0 = reference 500) "
                         "to bound per-keyframe wall in short runs")
    ap.add_argument("--quick", action="store_true",
                    help="small refine config for smoke-level runs")
    ap.add_argument("--report", default="")
    ap.add_argument("--skip_run", action="store_true",
                    help="evaluate existing artifacts only")
    ap.add_argument("--skip_refine", action="store_true",
                    help="online tracking only (pose-metric A/B runs)")
    ap.add_argument("--no_nerf", action="store_true",
                    help="disable online NOF: tracker-only isolation for "
                         "BA-schedule A/B arms (CPU-viable)")
    ap.add_argument("--device", default="cuda",
                    help="where tracking and the NOF run: the card unless "
                         "'cpu'")
    ap.add_argument("--orb_features", default="",
                    help="replay stored ORB features (an .npz of "
                         "tests/fixtures/gen_tracker_orb.py) instead of "
                         "detecting live")
    ap.add_argument("--track_override", action="append", default=[],
                    help="tracker-config delta 'dotted.key=value', e.g. "
                         "bundle.reassoc_iters=7 (repeatable; A/B harness)")
    ap.add_argument("--matcher", default="", choices=["", "gt"],
                    help="'gt': GT-oracle correspondences (GtMatcher, the "
                         "reference's findCorresbyGroundtruth): isolates "
                         "BA-schedule effects from matcher noise in A/Bs")
    args = ap.parse_args(argv)
    if args.matcher and args.orb_features:
        ap.error("--matcher gt and --orb_features exclude each other")

    from bundlesdf_tpu_torch.utils.common import set_logging_format
    set_logging_format()
    if not args.out:
        if args.skip_run:
            ap.error("--skip_run needs the --out of an earlier run")
        args.out = tempfile.mkdtemp(prefix="synth_bench_")
        logging.info(f"writing to {args.out}")
    video_dir = os.path.join(args.out, "video")
    out_folder = os.path.join(args.out, "run")
    if not args.skip_run:
        # score() globs every pose file and prefers any refined mesh, so
        # an earlier run's outputs would be scored as this run's
        stale = [n for n in ("ob_in_cam", "textured_mesh.obj")
                 if os.path.exists(os.path.join(out_folder, n))]
        if stale:
            ap.error(f"{out_folder} already holds {', '.join(stale)} of an "
                     "earlier run: give a new --out, or --skip_run to "
                     "score it")

    seq = write_sequence(video_dir, args.n_frames, args.H, args.W,
                         args.noise, protocol=args.protocol)
    t0 = time.perf_counter()
    if not args.skip_run:
        from bundlesdf_tpu_torch.run_custom import run_one_video
        overrides = {"n_step": args.refine_steps}
        if args.quick:
            overrides.update(dict(num_levels=6, finest_res=128,
                                  N_samples_around_depth=64,
                                  n_train_image=60, mesh_resolution=0.004))
        online = {"n_step": args.online_steps} if args.online_steps else None
        matcher = None
        if args.matcher == "gt":
            from bundlesdf_tpu_torch.matcher.gt import GtMatcher
            matcher = GtMatcher({id_str: seq["cam_in_obs"][i] for i, id_str
                                 in enumerate(seq["id_strs"])})
        elif args.orb_features:
            matcher = replay_matcher(args.orb_features, seq["id_strs"],
                                     args.device)
        run_one_video(video_dir, out_folder, stride=args.stride,
                      debug_level=1, refine_overrides=overrides,
                      online_overrides=online,
                      track_overrides=parse_track_overrides(
                          args.track_override) or None,
                      skip_refine=args.skip_refine,
                      start_nerf_keyframes=10 ** 9 if args.no_nerf else 5,
                      matcher=matcher, device=args.device)
    wall = time.perf_counter() - t0

    metrics = score(out_folder, seq, args.stride, args.protocol)
    metrics["wall_s"] = round(wall, 1)
    metrics["n_frames"] = args.n_frames
    metrics["resolution"] = f"{args.W}x{args.H}"
    metrics["depth_noise_m"] = args.noise
    metrics["protocol"] = args.protocol
    # the metrics.json key order of the JAX driver
    order = [k for k in metrics if k not in (
        "fail_frames", "recovered", "ADD_post_recovery(cm)")] + [
        k for k in ("fail_frames", "recovered", "ADD_post_recovery(cm)")
        if k in metrics]
    metrics = {k: metrics[k] for k in order}
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in metrics.items()}, indent=2))
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump({k: float(v) if isinstance(v, (int, float)) else v
                   for k, v in metrics.items()}, f, indent=2)

    if args.report:
        hdr = ("| sequence | ADD(cm) | ADD-S(cm) | ADD AUC(%) | "
               "ADD-S AUC(%) | Chamfer(cm) | wall(s) |\n"
               "|---|---|---|---|---|---|---|\n")
        row = (f"| synth {args.W}x{args.H}x{args.n_frames} "
               f"noise={args.noise * 1000:.0f}mm | {metrics['ADD(cm)']:.2f} | "
               f"{metrics['ADDS(cm)']:.2f} | {metrics['ADD_AUC(%)']:.1f} | "
               f"{metrics['ADDS_AUC(%)']:.1f} | "
               f"{metrics.get('chamfer(cm)', float('nan')):.2f} | "
               f"{metrics['wall_s']:.0f} |\n")
        exists = os.path.exists(args.report)
        with open(args.report, "a") as f:
            if not exists:
                f.write("# End-to-end benchmark results\n\n" + hdr)
            f.write(row)
    return metrics


if __name__ == "__main__":
    main()
