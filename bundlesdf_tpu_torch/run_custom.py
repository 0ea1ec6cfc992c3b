"""Command line: track + reconstruct a custom RGBD video with the port.

    python -m bundlesdf_tpu_torch.run_custom --mode run_video \
        --video_dir VIDEO --out_folder OUT
    python -m bundlesdf_tpu_torch.run_custom --mode global_refine --out_folder OUT
    python -m bundlesdf_tpu_torch.run_custom --mode postprocess_mesh --out_folder OUT
    python -m bundlesdf_tpu_torch.run_custom --mode draw_pose --out_folder OUT

Port of the repo's `run_custom.py` (ref `run_custom.py:210-228`), with its
modes, flags and config mutations. `run_video` tracks the video online
with the NOF on and then, unless told to skip it, runs `global_refine`:
the offline NOF at the refine config, trained from the artifacts the
online run saved, which leaves the cleaned, real-world and textured meshes
and the optimized keyframe poses. `--use_segmenter` reads each frame's
mask through `utils/segmentation.py::Segmenter` (with its background-cloud
subtraction) instead of the reader. Runs on the CUDA card unless
`--device cpu`; imports neither cv2 nor PyYAML (`draw_pose` draws with
`utils/viz.py`).
"""
from __future__ import annotations

import argparse
import copy
import glob
import os

import numpy as np
from scipy import ndimage

from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import (apply_dotted, default_nerf_config,
                                        default_track_config, dump_config,
                                        load_config, load_yaml)
from bundlesdf_tpu_torch.datasets import YcbineoatReader
from bundlesdf_tpu_torch.mesh import Mesh
from bundlesdf_tpu_torch.utils.common import (resize_nearest,
                                              set_logging_format, set_seed)
from bundlesdf_tpu_torch.utils.png import read_png, write_png
from bundlesdf_tpu_torch.utils.segmentation import Segmenter
from bundlesdf_tpu_torch.utils.viz import draw_posed_3d_box

# the offline refine's changes to the saved online NOF config (ref
# run_custom.py:121-128; the JAX package's T=2^24, run_custom.py:155-167)
REFINE_CONFIG = dict(
    n_step=2000, N_samples=64, N_samples_around_depth=256,
    first_frame_weight=1, down_scale_ratio=1, finest_res=256,
    num_levels=16, mesh_resolution=0.002, n_train_image=500, fs_sdf=0.1,
    frame_features=2, rgb_weight=100, log2_hashmap_size=24)


def make_configs(out_folder, debug_level=2):
    """Config mutations for the custom-video mode (ref run_custom.py:23-62)."""
    cfg_track = default_track_config()
    cfg_track["SPDLOG"] = int(debug_level)
    cfg_track["depth_processing"]["percentile"] = 95
    cfg_track["erode_mask"] = 3
    cfg_track["debug_dir"] = out_folder + "/"
    cfg_track["bundle"]["max_BA_frames"] = 10
    cfg_track["bundle"]["max_optimized_feature_loss"] = 0.03
    cfg_track["feature_corres"]["max_dist_neighbor"] = 0.02
    cfg_track["feature_corres"]["max_normal_neighbor"] = 30
    cfg_track["feature_corres"]["max_dist_no_neighbor"] = 0.01
    cfg_track["feature_corres"]["max_normal_no_neighbor"] = 20
    cfg_track["feature_corres"]["map_points"] = True
    cfg_track["feature_corres"]["resize"] = 400
    cfg_track["feature_corres"]["rematch_after_nerf"] = True
    cfg_track["keyframe"]["min_rot"] = 5
    cfg_track["ransac"]["inlier_dist"] = 0.01
    cfg_track["ransac"]["inlier_normal_angle"] = 20
    cfg_track["ransac"]["max_trans_neighbor"] = 0.02
    cfg_track["ransac"]["max_rot_deg_neighbor"] = 30
    cfg_track["ransac"]["max_trans_no_neighbor"] = 0.01
    cfg_track["ransac"]["max_rot_no_neighbor"] = 10
    cfg_track["p2p"]["max_dist"] = 0.02
    cfg_track["p2p"]["max_normal_angle"] = 45

    cfg_nerf = default_nerf_config()
    cfg_nerf["continual"] = True
    cfg_nerf["trunc_start"] = 0.01
    cfg_nerf["trunc"] = 0.01
    cfg_nerf["mesh_resolution"] = 0.005
    cfg_nerf["down_scale_ratio"] = 1
    cfg_nerf["fs_sdf"] = 0.1
    cfg_nerf["far"] = cfg_track["depth_processing"]["zfar"]
    cfg_nerf["datadir"] = f"{cfg_track['debug_dir']}/nerf_with_bundletrack_online"
    cfg_nerf["save_dir"] = cfg_nerf["datadir"]
    return cfg_track, cfg_nerf


def erode_mask(mask, k: int):
    """`cv2.erode(mask, np.ones((k, k)))` with its default anchor and
    border: the minimum over the k x k window; pixels outside the image
    never lower it."""
    mask = np.asarray(mask, np.uint8)
    return ndimage.minimum_filter(mask, size=(k, k), mode="constant",
                                  cval=255)


def run_one_video(video_dir, out_folder, use_segmenter=False, use_gui=False,
                  stride=1, debug_level=2, refine_overrides=None,
                  online_overrides=None, track_overrides=None,
                  skip_refine=False, start_nerf_keyframes=5, matcher=None,
                  device="cuda"):
    """@online_overrides: deltas on the ONLINE nerf config (e.g. n_step).
    @track_overrides: {dotted.key: value} deltas on the tracker config.
    @skip_refine: stop after online tracking.
    @start_nerf_keyframes: reference default 5 (run_custom.py:115); a huge
    value disables the online NOF.
    @matcher: optional matcher instance for BundleSdf (None = ORB).
    @device: where tracking and the NOF run (the card unless "cpu")."""
    set_seed(0)
    os.makedirs(out_folder, exist_ok=True)
    cfg_track, cfg_nerf = make_configs(out_folder, debug_level)
    apply_dotted(cfg_track, track_overrides)
    # dump the PRE-override config: run_one_video_global_nerf reloads
    # config_nerf.yml as the refine base, so online-only knobs (e.g.
    # n_step) do not leak into the offline refine settings
    dump_config(cfg_track, f"{out_folder}/config_bundletrack.yml")
    dump_config(cfg_nerf, f"{out_folder}/config_nerf.yml")
    cfg_nerf_online = copy.deepcopy(cfg_nerf)
    if online_overrides:
        cfg_nerf_online.update(online_overrides)

    tracker = BundleSdf(cfg_track=cfg_track, cfg_nerf=cfg_nerf_online,
                        start_nerf_keyframes=start_nerf_keyframes,
                        use_gui=use_gui, matcher=matcher, device=device)
    reader = YcbineoatReader(video_dir=video_dir, shorter_side=480)

    # per-frame segmenter (ref run_custom.py:64-91: reads the mask via
    # Segmenter.run on the rgb->masks path instead of the reader; XMem is
    # excluded upstream for license, so run() reads precomputed masks and
    # optionally subtracts a static background cloud)
    segmenter = Segmenter(cfg_track) if use_segmenter else None

    erode = cfg_track.get("erode_mask", 0)
    for i in range(0, len(reader.color_files), stride):
        color = reader.get_color(i)
        depth = reader.get_depth(i)
        if segmenter is not None:
            mask_file = reader.color_files[i].replace("rgb", "masks")
            mask = segmenter.run(mask_file, depth=depth, K=reader.K)
            if mask is not None and mask.shape[:2] != color.shape[:2]:
                mask = resize_nearest(mask, (color.shape[1], color.shape[0]))
        else:
            mask = reader.get_mask(i)
        if erode > 0 and mask is not None:
            mask = erode_mask(mask, erode)
        # occluder masks (HO3D masks_hand layout) ride along when present
        occ_mask = None
        if os.path.isdir(os.path.join(video_dir, "masks_hand")):
            occ_mask = reader.get_occ_mask(i)
        tracker.run(color, depth, reader.K.copy(), reader.id_strs[i],
                    mask=mask, occ_mask=occ_mask, pose_in_model=np.eye(4))
    tracker.on_finish()
    if skip_refine:
        return tracker
    return run_one_video_global_nerf(out_folder=out_folder,
                                     video_dir=video_dir,
                                     refine_overrides=refine_overrides,
                                     device=device)


def run_one_video_global_nerf(out_folder, video_dir=None,
                              refine_overrides=None, device="cuda"):
    """Offline high-quality refine (ref run_custom.py:110-154) at
    REFINE_CONFIG over the saved online NOF config. @refine_overrides:
    config deltas on top (e.g. to bound wall time). Returns the BundleSdf,
    whose `refine_stats` holds the refine's step count and seconds."""
    set_seed(0)
    cfg_track = load_config(f"{out_folder}/config_bundletrack.yml",
                            default_track_config())
    cfg_track["debug_dir"] = out_folder + "/"
    cfg_nerf = load_config(f"{out_folder}/config_nerf.yml",
                           default_nerf_config())
    cfg_nerf.update(REFINE_CONFIG)
    if refine_overrides:
        cfg_nerf.update(refine_overrides)
    cfg_nerf["datadir"] = f"{out_folder}/nerf_with_bundletrack_online"
    cfg_nerf["save_dir"] = cfg_nerf["datadir"]
    os.makedirs(cfg_nerf["datadir"], exist_ok=True)
    dump_config(cfg_nerf, f"{cfg_nerf['datadir']}/config.yml")

    tracker = BundleSdf(cfg_track=cfg_track, cfg_nerf=cfg_nerf,
                        start_nerf_keyframes=5, device=device)
    reader = (YcbineoatReader(video_dir=video_dir, downscale=1)
              if video_dir else None)
    tracker.run_global_nerf(reader=reader, get_texture=True, tex_res=512)
    print("Done")
    return tracker


def postprocess_mesh(out_folder):
    """Un-normalize the latest NOF mesh, keep the biggest component, smooth
    (ref run_custom.py:158-189)."""
    cands = (sorted(glob.glob(f"{out_folder}/**/*normalized_space.obj",
                              recursive=True))
             or sorted(glob.glob(f"{out_folder}/**/mesh_cleaned.obj",
                                 recursive=True)))
    mesh_file = cands[-1]
    print(f"Using {mesh_file}")
    os.makedirs(f"{out_folder}/mesh", exist_ok=True)
    mesh = Mesh.load(mesh_file)
    cfg = load_yaml(os.path.join(os.path.dirname(mesh_file), "config.yml"))
    tf = np.eye(4)
    tf[:3, 3] = np.asarray(cfg["translation"]).reshape(3)
    tf1 = np.eye(4)
    tf1[:3, :3] *= cfg["sc_factor"]
    mesh.apply_transform(np.linalg.inv(tf1 @ tf))
    mesh.export(f"{out_folder}/mesh/mesh_real_scale.obj")
    mesh.merge_vertices()
    mesh.keep_biggest_component()
    mesh.export(f"{out_folder}/mesh/mesh_biggest_component.obj")
    mesh.smooth_laplacian(lamb=0.5, iterations=3)
    mesh.export(f"{out_folder}/mesh/mesh_biggest_component_smoothed.obj")


def draw_pose(out_folder):
    """Render pose box overlays (ref run_custom.py:191-206); the lines are
    drawn as cv2.line draws them (`utils/viz.py`)."""
    K = np.loadtxt(f"{out_folder}/cam_K.txt").reshape(3, 3)
    color_files = sorted(glob.glob(f"{out_folder}/color/*"))
    mesh_file = f"{out_folder}/textured_mesh.obj"
    if not os.path.exists(mesh_file):
        cands = sorted(glob.glob(f"{out_folder}/**/mesh_real_world.obj",
                                 recursive=True))
        mesh_file = cands[-1]
    mesh = Mesh.load(mesh_file)
    to_origin, extents = mesh.oriented_bounds()
    bbox = np.stack([-extents / 2, extents / 2], axis=0)
    out_dir = f"{out_folder}/pose_vis"
    os.makedirs(out_dir, exist_ok=True)
    for color_file in color_files:
        color = read_png(color_file)
        pose = np.loadtxt(color_file.replace(".png", ".txt")
                          .replace("color", "ob_in_cam"))
        pose = pose @ np.linalg.inv(to_origin)
        vis = draw_posed_3d_box(K, color, ob_in_cam=pose, bbox=bbox,
                                line_color=(255, 255, 0))
        id_str = os.path.basename(color_file).replace(".png", "")
        write_png(f"{out_dir}/{id_str}.png", vis)


def main(argv=None):
    set_logging_format()
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str, default="run_video",
                        help="run_video/global_refine/draw_pose/"
                             "postprocess_mesh")
    parser.add_argument("--video_dir", type=str, default="")
    parser.add_argument("--out_folder", type=str, default="/tmp/bundlesdf_out")
    parser.add_argument("--use_segmenter", type=int, default=0)
    parser.add_argument("--use_gui", type=int, default=0)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--debug_level", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.mode == "run_video":
        run_one_video(args.video_dir, args.out_folder,
                      use_segmenter=bool(args.use_segmenter),
                      use_gui=bool(args.use_gui), stride=args.stride,
                      debug_level=args.debug_level, device=args.device)
    elif args.mode == "global_refine":
        run_one_video_global_nerf(out_folder=args.out_folder,
                                  video_dir=args.video_dir or None,
                                  device=args.device)
    elif args.mode == "draw_pose":
        draw_pose(args.out_folder)
    elif args.mode == "postprocess_mesh":
        postprocess_mesh(args.out_folder)
    else:
        raise RuntimeError(f"unknown mode {args.mode}")


if __name__ == "__main__":
    main()
