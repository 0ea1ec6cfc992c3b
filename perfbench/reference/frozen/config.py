"""Config system: two plain-dict configs (tracker + NOF), same keys as the
reference YAML schemas.

Reference: tracker schema `BundleTrack/config_ho3d.yml`, NOF schema
`config.yml`. A copy of the port's defaults; the port's YAML reading and
writing are left out of the frozen copy, whose callers pass dicts.
"""
from __future__ import annotations

import copy


def _deep_update(base: dict, override: dict) -> dict:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


# ---------------------------------------------------------------------------
# Tracker config (schema-compatible with BundleTrack/config_ho3d.yml)
# ---------------------------------------------------------------------------

def default_track_config() -> dict:
    return copy.deepcopy({
        "data_dir": "",
        "model_name": "",
        "model_dir": "",
        "debug_dir": "/tmp/bundlesdf_tpu",
        "init_pose_dir": "",
        # path to the pretrained LoFTR outdoor_ds.ckpt (readme.md:30-31);
        # when set and present, LoFTR drives matching instead of ORB
        "loftr_ckpt": "",
        "SPDLOG": 1,
        "depth_processing": {
            "zfar": 1.0,
            "erode": {"radius": 1, "diff": 0.001, "ratio": 0.8},
            "bilateral_filter": {"radius": 2, "sigma_D": 2, "sigma_R": 100000},
            "outlier_removal": {"num": 30, "std_mul": 3},
            "edge_normal_thres": 10,
            "denoise_cloud": False,
            "percentile": 100,
        },
        "visible_angle": 70,
        "bundle": {
            "num_iter_outter": 7,
            "num_iter_inner": 5,
            "window_size": 5,
            "max_BA_frames": 10,
            "subset_selection_method": "normal_orientation_nearest",
            "depth_association_radius": 5,
            "non_neighbor_max_rot": 90,
            "non_neighbor_min_visible": 0.1,
            "icp_pose_rot_thres": 60,
            "w_rpi": 0,
            "w_p2p": 1,
            "w_fm": 1,
            "w_sdf": 0,
            "w_pm": 0,
            # dense photometric (intensity) term — reference parity with
            # SolverBundling.cu:236-257 / SBA.cu:170 where
            # m_localWeightsDenseColor also defaults to 0 but is
            # config-reachable. >0 stores grey maps in the frame pool and
            # adds the bilinear photometric residual to the BA. Useful
            # values are SMALL (0.05-0.1): the term is a tie-breaker for
            # in-plane directions the depth term can't see, and larger
            # weights let the non-convex photometric cost overpower the
            # geometry (see BAConfig.w_dense_color).
            "w_dense_color": 0,
            "robust_delta_color": 0.03,
            "robust_delta": 0.005,
            "min_fm_edges_newframe": 15,
            "image_downscale": [4],
            # TPU BA association schedule (tracker/ba.py): the reference
            # re-associates the dense term every outer GN iteration
            # (SolverBundling.cu:1168-1260) with a radius-5 window; set
            # reassoc_iters == num_iter_outter and assoc_stride_first == 1
            # to recover exact reference semantics. Defaults are the fast
            # schedule A/B-validated on the occluder protocol (docs/PERF.md)
            "reassoc_iters": 1,
            "assoc_stride_first": 2,
            # refine-pass association: "window" (reference radius-2 NN
            # search) or "projective" (single-tap, KinectFusion-style).
            # NOTE: refine re-association runs only for GN iterations
            # 1..reassoc_iters-1, so this knob takes effect ONLY when
            # reassoc_iters > 1 — at the default schedule (1) the entry
            # association is frozen for all iterations and this is inert.
            # The windowed pass costs P*D*~125ns of slice descriptors
            # (the BA's TPU roofline) where projective is a ~12ns/row
            # gather. Default flipped to projective after the glyph-
            # fixture occluder A/B (docs/PERF.md r4 batch 2): the fast
            # stack matches/beats windowed on the stress case
            # (ADD 0.745 vs 0.913 cm) while removing the slice cost.
            "assoc_refine_mode": "projective",
            # entry-pass association: "window" (reference wide radius-5
            # strided search — absorbs bad pose inits), "projective", or
            # "hybrid" (windowed only for pairs touching the NEW frame —
            # the one pose with fresh error — projective for the old-old
            # pairs the previous BA already converged); the entry pass is
            # the largest single op of the steady frame. Default = hybrid
            # after the occluder A/B (PERF.md r4 batch 2: hybrid ADD
            # 0.749 cm vs window 0.913, post-recovery 0.57 vs 0.83).
            "assoc_entry_mode": "hybrid",
            # association scoring layout (ba.py): "lane" transposes the
            # gathered patches to (taps,6,D) for full 128-lane VPU rows;
            # measured 2.2x faster than the native "point" layout despite
            # the relayout copy (39.0 vs 87.6 ms entry pass on-chip)
            "assoc_layout": "lane",
            # association scoring precision (ba.py): "bf16" halves the
            # candidate-window gather bytes and re-fetches the selected
            # candidate in f32 (exact residuals; only near-tie candidate
            # SELECTION sees the ~1 mm bf16 position quantum). Default =
            # bf16: accuracy-neutral on both protocols (occluder A/B
            # delta < 0.01 cm, PERF.md r4 batch 2) at half the gather
            # bytes of the BA's dominant op.
            "assoc_dtype": "bf16",
            # GN convergence early-out: stop outer iterations once the max
            # per-frame update norm falls below this (the reference ships
            # the same check behind ENABLE_EARLY_OUT, threshold 5e-3,
            # SolverBundling.cu:1244-1252, compiled out by default; 0
            # disables). 1e-4 = 0.1 mm / 0.1 mrad scale, far below sensor
            # noise
            "early_out_delta": 1e-4,
            "feature_edge_dist_thres": 0.01,
            "feature_edge_normal_thres": 30,
            "max_optimized_feature_loss": 0.03,
        },
        "keyframe": {
            "min_interval": 1,
            "min_feat_num": 0,
            "min_trans": 0,
            "min_rot": 5,
            "min_visible": 1,
        },
        "feature_corres": {
            "mutual": True,
            "map_points": False,
            "max_dist_no_neighbor": 999,
            "max_normal_no_neighbor": 180,
            "max_dist_neighbor": 0.02,
            "max_normal_neighbor": 30,
            "suppression_patch_size": 5,
            "max_view_normal_angle": 180,
            "min_match_with_ref": 5,
            "resize": 400,
            "rematch_after_nerf": False,
        },
        "ransac": {
            "max_iter": 2000,
            "num_sample": 3,
            "inlier_dist": 0.005,
            "inlier_normal_angle": 30,
            "desired_succ_rate": 0.99,
            "max_trans_neighbor": 0.02,
            "max_rot_deg_neighbor": 30,
            "max_trans_no_neighbor": 999,
            "max_rot_no_neighbor": 180,
            "epipolar_thres": 1,
            "min_match_after_ransac": 5,
        },
        "p2p": {"projective": False, "max_dist": 0.01, "max_normal_angle": 20},
        "sdf_edge": {"max_dist": 0.02},
        "segmentation": {"ob_scales": [0.3, 0.3, 0.3], "tolerance": 0.03},
        "shape": {
            "res": 0.005,
            "xrange": [-0.2, 0.2],
            "yrange": [-0.2, 0.2],
            "zrange": [-0.2, 0.2],
            "max_weight": 100,
            "truncate_dist": 0.005,
        },
    })


# ---------------------------------------------------------------------------
# NOF config (schema-compatible with config.yml)
# ---------------------------------------------------------------------------

def default_nerf_config() -> dict:
    return copy.deepcopy({
        "notes": "",
        "n_step": 500,
        "N_rand": 2048,
        "first_frame_ray_in_batch": 0,
        "lrate": 0.01,
        "lrate_pose": 0.01,
        "pose_optimize_start": 0,
        "decay_rate": 0.1,
        "chunk": 99999999999,
        "netchunk": 6553600,
        "no_batching": 0,
        "amp": True,
        "N_samples": 128,
        "N_samples_around_depth": 64,
        "N_importance": 0,
        "N_importance_iter": 1,
        "perturb": 1,
        "use_viewdirs": 1,
        "i_embed": 1,
        "i_embed_views": 2,
        "multires": 8,
        "multires_views": 3,
        "feature_grid_dim": 2,
        "raw_noise_std": 0,
        "white_bkgd": 0,
        "gradient_max_norm": 0.1,
        "gradient_pose_max_norm": 0.1,
        "i_print": 999999,
        "i_img": 999999,
        "i_weights": 999999,
        "i_mesh": 999999,
        "i_pose": 999999,
        # experiment scalar/artifact sink dir (sacred-equivalent seam,
        # ref nerf_runner.py:569-576); "" = disabled
        "experiment_log": "",
        "save_octree_clouds": False,
        "finest_res": 128,
        "base_res": 16,
        "num_levels": 4,
        "log2_hashmap_size": 22,
        "datadir": "",
        "n_train_image": 300,
        "use_octree": 1,
        "first_frame_weight": 10,
        "denoise_depth_use_octree_cloud": True,
        "octree_embed_base_voxel_size": 0.02,
        "octree_smallest_voxel_size": 0.02,
        "octree_raytracing_voxel_size": 0.02,
        "octree_dilate_size": 0.02,
        "down_scale_ratio": 1,
        "bounding_box": [[-1, -1, -1], [1, 1, 1]],
        "use_mask": 1,
        "dilate_mask_size": 0,
        "rays_valid_depth_only": True,
        "near": 0.1,
        "far": 2,
        "rgb_weight": 10,
        "depth_weight": 0,
        "trunc": 0.01,
        "trunc_start": 0.01,
        "sdf_lambda": 5,
        "neg_trunc_ratio": 1,
        "trunc_decay_type": "",
        "sdf_loss_type": "l2",
        "fs_weight": 100,
        "empty_weight": 0.01,
        "fs_rgb_weight": 0,
        "trunc_weight": 6000,
        "sparse_loss_weight": 0,
        "tv_loss_weight": 0,
        "frame_features": 0,
        "optimize_poses": 1,
        "pose_reg_weight": 0,
        "eikonal_weight": 0,
        "normal_loss_weight": 0,
        "feature_reg_weight": 0.1,
        "share_coarse_fine": 1,
        "mode": "sdf",
        "fs_sdf": 0.001,
        "crop": 0,
        "mesh_resolution": 0.005,
        "max_trans": 0.02,
        "max_rot": 20,
        "continual": True,
        "dbscan_eps": 0.06,
        "dbscan_eps_min_samples": 1,
        "sync_max_delay": 0,
        # NOF host-pipeline placement. The reference runs the whole NOF
        # batch (scene bounds, ray store, training, checkpoint) in a child
        # PROCESS (bundlesdf.py:64-260) so the tracker thread never pays
        # its host cost. async_host=True is the TPU-native equivalent: a
        # worker THREAD owns batch prep + scan dispatch + drain, and the
        # tracker blocks only on the sync_max_delay gate. None (default)
        # resolves to True when sync_max_delay > 0 (overlap mode), False
        # for strict sync where threading buys nothing and the
        # single-threaded path keeps tests deterministic.
        "async_host": None,
        # tracker||NOF placement (SURVEY §2.3): -1 = share the tracker's
        # chip (NOF scans serialize against tracking on one instruction
        # stream); >=0 = commit all NOF state + training dispatches to
        # jax.devices()[nerf_device] so the two genuinely overlap.
        # Mutually exclusive with dp_devices (ray-DP).
        "nerf_device": -1,
        # ray-DP the scanned train step over the first N devices
        # (parallel/dp.py shard_map + pmean); 0/1 = single device
        "dp_devices": 0,
        "save_dir": "/tmp/bundlesdf_tpu/nerf",
    })
