"""Command line: track and reconstruct HO3D videos with the port.

    python -m bundlesdf_tpu_torch.run_ho3d --video_dirs V1,V2 [--out_dir OUT] \
        [--mode run_video|global_refine] [--parallel_videos N] \
        [--use_gui 1] [--device cpu]

Port of the repo's `run_ho3d.py` (ref `run_ho3d.py:18-119`), with its
configs and modes. `run_video` tracks each video online with the NOF on
(`SPDLOG` 2, `zfar` 1, truncation 0.01) and writes the two config files
the refine reloads; `--parallel_videos N` interleaves N videos frame by
frame in one process (`parallel/videos.py`). `global_refine` trains the
offline NOF at HO3D's refine config (finest resolution 512, 16 levels,
128 samples, T=2^24, mesh at 0.003 m) on a run's saved keyframes. Frames
are read by `datasets.Ho3dReader` (JPEGs through `utils/jpeg.py`). Runs on
the CUDA card unless `--device cpu`; imports neither cv2 nor PyYAML.
A video whose folder under `--out_dir` already holds every frame's pose
is skipped, as in the reference; without `--out_dir`, `run_video` writes
to a new temporary folder, and `global_refine` refuses to start.
"""
from __future__ import annotations

import argparse
import copy
import glob
import os
import tempfile

import torch

from bundlesdf_tpu_torch.bundlesdf import BundleSdf
from bundlesdf_tpu_torch.config import (default_nerf_config,
                                        default_track_config, dump_config,
                                        load_config)
from bundlesdf_tpu_torch.datasets import Ho3dReader
from bundlesdf_tpu_torch.utils.common import set_logging_format, set_seed

# the offline refine's changes to the saved online NOF config (ref
# run_ho3d.py:111-116)
REFINE_CONFIG = dict(n_step=2000, N_samples=128, down_scale_ratio=1,
                     finest_res=512, num_levels=16, mesh_resolution=0.003,
                     log2_hashmap_size=24)


def _video_done(reader, out_folder):
    if os.path.exists(f"{out_folder}/ob_in_cam"):
        pose_files = sorted(glob.glob(f"{out_folder}/ob_in_cam/*.txt"))
        if len(pose_files) == len(reader.color_files):
            return True
    return False


def _make_tracker(video_dir, out_folder, use_gui=False, device="cuda"):
    os.makedirs(out_folder, exist_ok=True)
    cfg_track = default_track_config()
    cfg_track["data_dir"] = video_dir
    cfg_track["SPDLOG"] = 2
    cfg_track["depth_processing"]["zfar"] = 1
    cfg_track["debug_dir"] = out_folder
    dump_config(cfg_track, f"{out_folder}/config_bundletrack.yml")

    cfg_nerf = default_nerf_config()
    cfg_nerf["trunc_start"] = 0.01
    cfg_nerf["trunc"] = 0.01
    cfg_nerf["down_scale_ratio"] = 1
    cfg_nerf["far"] = cfg_track["depth_processing"]["zfar"]
    cfg_nerf["datadir"] = f"{out_folder}/nerf_with_bundletrack_online"
    cfg_nerf["save_dir"] = copy.deepcopy(cfg_nerf["datadir"])
    dump_config(cfg_nerf, f"{out_folder}/config_nerf.yml")

    return BundleSdf(cfg_track=cfg_track, cfg_nerf=cfg_nerf,
                     start_nerf_keyframes=5, use_gui=use_gui, device=device)


def run_one_video(video_dir, out_dir, use_gui=False, device="cuda"):
    """Track one video into `<out_dir>/<video name>/`. Returns the
    BundleSdf, or None when the folder already holds every frame's pose."""
    set_seed(0)
    reader = Ho3dReader(video_dir)
    out_folder = f"{out_dir}/{reader.get_video_name()}/"
    if _video_done(reader, out_folder):
        print(f"{out_folder} done before, skip")
        return None
    tracker = _make_tracker(video_dir, out_folder, use_gui=use_gui,
                            device=device)
    for i in range(len(reader.color_files)):
        color = reader.get_color(i)
        depth = reader.get_depth(i)
        mask = reader.get_mask(i)
        occ_mask = reader.get_occ_mask(i)
        tracker.run(color, depth, reader.K, reader.id_strs[i], mask=mask,
                    occ_mask=occ_mask)
    tracker.on_finish()
    print(f"Done {video_dir}")
    return tracker


def run_videos(video_dirs, out_dir, parallel_videos=0, use_gui=False,
               device="cuda"):
    """Run many videos; with @parallel_videos > 1, that many videos at a
    time interleave frame by frame in this process (the reference runs
    videos one after another, run_ho3d.py:116-119). @device "cuda" puts
    them on the visible cards in turn; any other device, such as "cpu" or
    "cuda:1", runs all of them there."""
    if parallel_videos <= 1:
        for video_dir in video_dirs:
            run_one_video(video_dir, out_dir, use_gui=use_gui, device=device)
        return
    from bundlesdf_tpu_torch.parallel.videos import run_videos_parallel

    set_seed(0)
    jobs = []
    video_of = {}  # out_folder -> video_dir for the tracker factory
    for video_dir in video_dirs:
        reader = Ho3dReader(video_dir)
        out_folder = f"{out_dir}/{reader.get_video_name()}/"
        if _video_done(reader, out_folder):
            print(f"{out_folder} done before, skip")
            continue
        video_of[out_folder] = video_dir
        jobs.append((reader, out_folder))

    def make_tracker(out_folder, dev):
        return _make_tracker(video_of[out_folder], out_folder, device=dev)

    # a bare "cuda" spreads the videos over every visible card; a named
    # device ("cpu", "cuda:1") takes all of them
    devices = None
    if device != "cuda":
        devices = [torch.device(device)] * parallel_videos
    for s in range(0, len(jobs), parallel_videos):
        run_videos_parallel(jobs[s:s + parallel_videos],
                            make_tracker=make_tracker,
                            n_devices=parallel_videos, devices=devices)


def run_one_video_global_nerf(video_dir, out_dir, refine_overrides=None,
                              device="cuda"):
    """Offline refine (ref run_ho3d.py:104-123) at REFINE_CONFIG over the
    saved online NOF config. @refine_overrides: config deltas on top (e.g.
    to bound wall time). Returns the BundleSdf, whose `refine_stats` holds
    the refine's step count and seconds."""
    set_seed(0)
    reader = Ho3dReader(video_dir)
    out_folder = f"{out_dir}/{reader.get_video_name()}/"
    cfg_track = load_config(f"{out_folder}/config_bundletrack.yml",
                            default_track_config())
    cfg_nerf = load_config(f"{out_folder}/config_nerf.yml",
                           default_nerf_config())
    cfg_nerf.update(REFINE_CONFIG)
    if refine_overrides:
        cfg_nerf.update(refine_overrides)
    cfg_nerf["datadir"] = f"{out_folder}/nerf_with_bundletrack_online"
    cfg_nerf["save_dir"] = copy.deepcopy(cfg_nerf["datadir"])
    tracker = BundleSdf(cfg_track=cfg_track, cfg_nerf=cfg_nerf,
                        start_nerf_keyframes=5, device=device)
    tracker.debug_dir = out_folder
    tracker.run_global_nerf()
    print(f"Done {video_dir}")
    return tracker


def main(argv=None):
    set_logging_format()
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_dirs", type=str, required=True,
                        help="comma-separated HO3D video dirs")
    parser.add_argument("--out_dir", type=str, default="",
                        help="run_video: default a new temporary folder; "
                             "global_refine: the run_video --out_dir")
    parser.add_argument("--mode", type=str, default="run_video",
                        choices=["run_video", "global_refine"])
    parser.add_argument("--use_gui", type=int, default=0)
    parser.add_argument("--parallel_videos", type=int, default=0,
                        help="interleave N videos in this process "
                             "(run_video mode only), on the visible cards "
                             "in turn with --device cuda, else all on "
                             "--device")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not args.out_dir:
        if args.mode == "global_refine":
            parser.error("global_refine needs the --out_dir of a run_video "
                         "run")
        args.out_dir = tempfile.mkdtemp(prefix="ho3d_ours_")
        print(f"writing to {args.out_dir}")

    video_dirs = args.video_dirs.split(",")
    if args.mode == "run_video":
        run_videos(video_dirs, args.out_dir,
                   parallel_videos=args.parallel_videos,
                   use_gui=bool(args.use_gui), device=args.device)
    else:
        for video_dir in video_dirs:
            run_one_video_global_nerf(video_dir, args.out_dir,
                                      device=args.device)


if __name__ == "__main__":
    main()
