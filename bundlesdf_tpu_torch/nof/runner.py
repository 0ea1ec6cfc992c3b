"""NofRunner -- per-video Neural Object Field trainer.

Port of `bundlesdf_tpu/nof/runner.py` (the re-design of the reference
`NerfRunner`, `nerf_runner.py:112-433`): same inputs (normalized keyframe
images/depths/masks/normals + GL poses + a point cloud for the occupancy
grid), same outputs (optimized poses, mesh). Ray construction happens once
on the host in numpy; the ray store is a dict of device tensors, with a
host mirror that continual batches extend (`add_new_frames`). Training is
eager PyTorch in chunks of `scan_chunk` steps, synchronously (`train`) or
chunk by chunk without host waits (`start/poll/finish_training`).

Every device call of the runner runs on its own CUDA stream
(`self.stream`), whichever thread calls it: the orchestrator's NOF worker
thread and the tracker then share the card the way the JAX package's
`nerf_device` shares a second chip. A chunk is ready when a CUDA event
recorded behind its metrics copy has completed (`utils/transfer.py`).

Placement (`nof_devices`), as in the JAX package: cfg `nerf_device: k`
puts the runner on card k (the tracker stays on its own device); cfg
`dp_devices: N > 1`, or an explicit `dp_devices=` device list, trains
with ray data parallelism over replicas of the field
(`parallel/dp.py`), which takes precedence. Too few cards for either
warns and stays on the given device. Under DP `self.field` and
`self.optimizer` are the master replica: every chunk starts by copying
them into the other replicas, so whatever changed the master between
chunks (`train_ba`, `load_weights`, `copy_from`, `add_new_frames`)
reaches them, and the master stays authoritative for meshes, renders,
poses and checkpoints.

Not carried from the JAX package: the frame and ray buckets (their padding
only fed XLA's compile cache and was masked) and the TPU-only `k_runs`
overflow telemetry.
"""
from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.mesh import Mesh, marching_tetrahedra
from bundlesdf_tpu_torch.nof.losses import LossConfig
from bundlesdf_tpu_torch.nof.models import (NofField, NofSpec,
                                            params_from_jax, params_to_jax,
                                            pose_array_matrices)
from bundlesdf_tpu_torch.nof.render import RenderConfig, render_rays
from bundlesdf_tpu_torch.nof.train import (StepGraph, TrainConfig,
                                           make_optimizer, train_steps)
from bundlesdf_tpu_torch.ops.hashgrid import HashGridSpec
from bundlesdf_tpu_torch.ops.occupancy import (OccupancyGrid,
                                               build_occupancy_grid,
                                               query_occupancy)
from bundlesdf_tpu_torch.parallel.dp import (make_ray_devices, make_replicas,
                                             set_master, shard_rays,
                                             train_steps_dp)
from bundlesdf_tpu_torch.scene.bounds import voxel_downsample
from bundlesdf_tpu_torch.utils.common import (BAD_COLOR, BAD_DEPTH,
                                              GLCAM_IN_CVCAM)
from bundlesdf_tpu_torch.utils.png import write_png
from bundlesdf_tpu_torch.utils.profiling import span, spanned
from bundlesdf_tpu_torch.utils.se3 import se3_exp_np
from bundlesdf_tpu_torch.utils.transfer import HostPull


def preprocess_frame_data(rgbs, depths, masks, normal_maps, poses, sc_factor,
                          translation):
    """Normalize raw keyframe data into NOF space (ref `preprocess_data`
    nerf_helpers.py:218-240): sentinel-fill masked-out pixels, scale depth,
    normalize poses. Arrays are modified copies."""
    rgbs = np.array(rgbs)
    depths = np.array(depths, np.float32)
    poses = np.array(poses, np.float64)
    depths[depths < 0.1] = BAD_DEPTH
    if masks is not None:
        masks = np.array(masks)
        rgbs[masks == 0] = BAD_COLOR
        depths[masks == 0] = BAD_DEPTH
        if normal_maps is not None:
            normal_maps = np.array(normal_maps)
            normal_maps[..., [1, 2]] *= -1  # to OpenGL
            normal_maps[masks == 0] = 0
        masks = masks[..., None]
    rgbs = (rgbs / 255.0).astype(np.float32)
    depths = depths * sc_factor
    depths = depths[..., None]
    poses[:, :3, 3] += translation
    poses[:, :3, 3] *= sc_factor
    return rgbs, depths, masks, normal_maps, poses


def get_camera_rays_np(H, W, K):
    """Pinhole rays in the OpenGL convention (y up, z backward), matching
    `get_camera_rays_np` (nerf_helpers.py:358-363)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    return np.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                     -np.ones_like(i)], axis=-1)


def ray_box_near_far(origins, dirs, bounds):
    """Per-ray entry/exit of an AABB; returns z-depth (|unit_dir.z| scaled)
    near/far and a hit mask (ref `ray_box_intersection_batch`
    nerf_helpers.py:403-446 + `compute_near_far_and_filter_rays`
    nerf_runner.py:39-65)."""
    dirs_unit = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-10)
    inv = 1.0 / np.where(np.abs(dirs_unit) < 1e-12, 1e-12, dirs_unit)
    t0 = (bounds[0] - origins) * inv
    t1 = (bounds[1] - origins) * inv
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    tmin = np.where(tmin < 0, 0.0, tmin)  # per-axis clamp as in the reference
    near = tmin.max(axis=-1)
    far = tmax.min(axis=-1)
    hit = near <= far
    return near, far, hit


def nof_devices(cfg, device, dp_devices=None, n_visible=None):
    """(the runner's device, the DP replica devices or None) for a runner
    built on @device with @cfg's `dp_devices` (a replica count) and
    `nerf_device` (a card index). @dp_devices: an explicit replica device
    list (may repeat a card), which overrides both. A count N > 1 takes
    cards 0..N-1 (on the CPU, N replicas share it) and takes precedence
    over `nerf_device`; `nerf_device: k` on a card puts the runner on card
    k. With fewer than N (or k + 1) cards visible -- @n_visible, by
    default what torch sees; the CPU counts as one device -- it warns
    and trains on @device alone, as the JAX package does."""
    device = torch.device(device)
    if dp_devices is not None:
        devs = make_ray_devices(dp_devices)
        if len(devs) < 2:
            raise ValueError(f"dp_devices={dp_devices}: data parallelism "
                             f"needs two replicas or more")
        return devs[0], devs
    cuda = device.type == "cuda"
    if n_visible is None:
        n_visible = torch.cuda.device_count() if cuda else 1
    n_dp = int(cfg.get("dp_devices", 0) or 0)
    if n_dp > 1:
        if not cuda:
            return device, make_ray_devices(n_dev=n_dp, base=device)
        if n_visible >= n_dp:
            return torch.device("cuda", 0), [torch.device("cuda", i)
                                             for i in range(n_dp)]
        logging.warning(f"dp_devices={n_dp} but only {n_visible} devices "
                        "visible; training single-device")
    nd = int(cfg.get("nerf_device", -1))
    if nd >= 0:
        if nd < n_visible:
            return (torch.device("cuda", nd) if cuda else device), None
        logging.warning(f"nerf_device={nd} but only {n_visible} devices "
                        "visible; staying on default")
    return device, None


def dilate_mask(mask, k: int):
    """Binary dilation with a k x k square, equal to `cv2.dilate(mask,
    np.ones((k, k)))` with its default anchor (k // 2, k // 2): for even k
    both place the window over offsets [-(k//2), k - 1 - k//2]. Pixels
    outside the image never contribute."""
    return ndimage.maximum_filter(mask, size=(k, k), mode="constant", cval=0)


class NofRunner:
    """Owns the NOF field, optimizer and ray store for one (growing)
    keyframe set.

    @cfg: NOF config dict (schema of config.yml) with 'sc_factor' and
    'translation' already set.
    @images/depths/masks/normal_maps: outputs of `preprocess_frame_data`.
    @poses: (F,4,4) normalized GL cam-to-object.
    @build_octree_pts: (N,3) normalized cloud for the occupancy grid.
    @device: torch device every tensor of the runner lives on (the card
    unless "cpu").
    @stream: CUDA stream for all of the runner's device work (a new one
    when None or on another device; unused on the CPU).
    @dp_devices: explicit DP replica devices (`nof_devices`), e.g.
    ["cuda:0", "cuda:0"] for two replicas sharing one card.
    """

    # steps a chunk dispatches between readiness checks and metrics pulls
    # (the JAX package's scan chunk); the interval hooks fire between chunks
    SCAN_CHUNK = 50

    def __init__(self, cfg, images, depths, masks, normal_maps, poses, K,
                 occ_masks=None, build_octree_pts=None, seed=0,
                 exp_logger=None, device="cuda", stream=None,
                 dp_devices=None):
        self.cfg = cfg
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.dp_devices = nof_devices(cfg, device, dp_devices)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = (stream if stream is not None
                           and stream.device == self.device
                           else torch.cuda.Stream(device=self.device))
        # ray data parallelism: replicas built at the first chunk (then
        # `dp_replicas`, replica 0 the master); the store's shards are
        # rebuilt whenever the store changes
        self._seed = seed
        self.dp_replicas = None
        # experiment scalar/artifact sink (ref attaches a sacred _run,
        # nerf_runner.py:569-576,820-822)
        if exp_logger is None:
            from bundlesdf_tpu_torch.utils.explog import make_experiment_logger
            exp_logger = make_experiment_logger(cfg)
        self.exp_logger = exp_logger
        self.images = np.asarray(images)
        self.depths = np.asarray(depths)
        self.masks = np.asarray(masks)
        self.normal_maps = None if normal_maps is None else np.asarray(normal_maps)
        self.occ_masks = None if occ_masks is None else np.asarray(occ_masks)
        self.poses = np.asarray(poses, np.float64)
        self.K = np.asarray(K, np.float64).copy()
        self.build_octree_pts = (None if build_octree_pts is None
                                 else np.asarray(build_octree_pts))
        self.mesh = None
        self.global_step = 0
        self.N_iters = cfg["n_step"] + 1
        self._async = None
        # the training step as a CUDA graph (on CUDA); it recaptures
        # whenever a step's tensors were rebound (`nof/train.py`)
        self._step_graph = StepGraph()

        down = int(cfg.get("down_scale_ratio", 1))
        if down != 1:
            H, W = self.images.shape[1:3]
            self.images = self.images[:, ::down, ::down]
            self.depths = self.depths[:, ::down, ::down]
            self.masks = self.masks[:, ::down, ::down]
            if self.normal_maps is not None:
                self.normal_maps = self.normal_maps[:, ::down, ::down]
            if self.occ_masks is not None:
                self.occ_masks = self.occ_masks[:, ::down, ::down]
            h2, w2 = self.images.shape[1:3]
            self.K[0] *= float(w2) / W
            self.K[1] *= float(h2) / H
        self.H, self.W = self.images.shape[1:3]

        sc = cfg["sc_factor"]
        with self._on_stream():
            self.occ_grid = self._build_occupancy()

        amp = bool(cfg.get("amp", True))
        grid = HashGridSpec(
            n_levels=cfg["num_levels"], level_dim=cfg["feature_grid_dim"],
            base_res=cfg["base_res"], finest_res=cfg["finest_res"],
            log2_hashmap_size=cfg["log2_hashmap_size"], table_bf16=amp)
        self.spec = NofSpec(
            grid=grid, sh_degree=cfg["multires_views"],
            frame_features=cfg["frame_features"],
            n_frames=len(self.images),
            max_trans=cfg["max_trans"] * sc, max_rot_deg=cfg["max_rot"],
            use_viewdirs=bool(cfg["use_viewdirs"]),
            i_embed=int(cfg.get("i_embed", 1)),
            i_embed_views=int(cfg.get("i_embed_views", 2)),
            multires=int(cfg.get("multires", 8)))
        self.rcfg = RenderConfig(
            n_samples=cfg["N_samples"],
            n_samples_around_depth=cfg["N_samples_around_depth"],
            trunc=cfg["trunc"] * sc, neg_trunc_ratio=cfg["neg_trunc_ratio"],
            sdf_lambda=cfg["sdf_lambda"], near=cfg["near"] * sc,
            far=cfg["far"] * sc,
            # n_steps >= trace_res keeps the no-skip guarantee
            # (ops/occupancy.py)
            n_trace_steps=int(cfg.get("n_trace_steps",
                                      self.occ_grid.trace_res)),
            raw_noise_std=cfg["raw_noise_std"],
            n_importance=int(cfg.get("N_importance", 0)),
            n_importance_iter=int(cfg.get("N_importance_iter", 1)),
            compute_bf16=amp,
            eikonal=float(cfg["eikonal_weight"]) > 0)
        self.lcfg = LossConfig(
            rgb_weight=cfg["rgb_weight"], fs_weight=cfg["fs_weight"],
            empty_weight=cfg["empty_weight"], trunc_weight=cfg["trunc_weight"],
            fs_rgb_weight=cfg["fs_rgb_weight"],
            eikonal_weight=cfg["eikonal_weight"],
            feature_reg_weight=cfg["feature_reg_weight"],
            pose_reg_weight=cfg["pose_reg_weight"],
            first_frame_weight=cfg["first_frame_weight"],
            fs_sdf=cfg["fs_sdf"], near=cfg["near"] * sc, far=cfg["far"] * sc,
            neg_trunc_ratio=cfg["neg_trunc_ratio"])
        self.tcfg = TrainConfig(
            n_step=cfg["n_step"], n_rand=cfg["N_rand"], lrate=cfg["lrate"],
            # pose gradients still flow but are multiplied by lr 0
            lrate_pose=cfg["lrate_pose"] if cfg["optimize_poses"] else 0.0,
            decay_rate=cfg["decay_rate"],
            trunc=cfg["trunc"] * sc, trunc_start=cfg["trunc_start"] * sc,
            trunc_decay_type=cfg["trunc_decay_type"])

        with self._on_stream():
            # one generator drives init, batch draws and sample jitter; it
            # belongs to the runner, so a worker thread never shares it
            self.generator = torch.Generator(
                device=self.device).manual_seed(seed)
            self.field = NofField(self.spec, generator=self.generator,
                                  device=self.device)
            self.optimizer = make_optimizer(self.field, self.tcfg)
            self.c2w = torch.as_tensor(self.poses, dtype=torch.float32,
                                       device=self.device)
            self._rays_host = self._build_ray_store()
            self._upload_rays()

    def _on_stream(self):
        """Make the runner's stream current for the calling thread (PyTorch
        keeps the current stream per thread); a no-op on the CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _upload_rays(self):
        """Device ray store from the host mirror: one upload per column.
        float64 host columns (the ray dirs) become float32 on the device,
        as jax's default 32-bit mode does in the JAX package."""
        self.n_rays_valid = int(self._rays_host["depth"].shape[0])
        self._dp_rays = None
        self.rays = {k: torch.as_tensor(np.ascontiguousarray(
            v.astype(np.float32) if v.dtype == np.float64 else v),
            device=self.device) for k, v in self._rays_host.items()}

    # -- dataset -----------------------------------------------------------

    @spanned("nof.occupancy")
    def _build_occupancy(self) -> OccupancyGrid:
        """Occupancy grid from the (normalized) scene cloud with the
        reference's voxel-size and dilation math (`build_octree`
        nerf_runner.py:436-489)."""
        cfg = self.cfg
        sc = cfg["sc_factor"]
        vs = cfg["octree_smallest_voxel_size"] * sc
        max_level = int(np.ceil(np.log2(2.0 / vs)))
        res = 2 ** max_level
        dilate_radius = max(1, int(np.ceil(cfg["octree_dilate_size"]
                                           / cfg["octree_smallest_voxel_size"])))
        pts = self.build_octree_pts
        if pts is None:  # fall back to depth-projected cloud
            pts = self._depth_cloud()
        return build_occupancy_grid(pts, res=res, dilate_radius=dilate_radius,
                                    trace_factor=int(cfg.get("trace_factor",
                                                             2)),
                                    device=self.device)

    def _depth_cloud(self):
        pts = []
        for i in range(len(self.images)):
            d = self.depths[i, ..., 0]
            m = (self.masks[i, ..., 0] > 0) & (d > 0.1 * self.cfg["sc_factor"]) \
                & (d < BAD_DEPTH * self.cfg["sc_factor"] * 0.9)
            vs, us = np.nonzero(m)
            z = d[vs, us]
            x = (us - self.K[0, 2]) * z / self.K[0, 0]
            y = (vs - self.K[1, 2]) * z / self.K[1, 1]
            p_cam = np.stack([x, -y, -z], axis=-1)  # GL
            p_w = p_cam @ self.poses[i][:3, :3].T + self.poses[i][:3, 3]
            pts.append(p_w)
        return np.clip(np.concatenate(pts, axis=0), -1, 1)

    def make_frame_rays(self, frame_id):
        """Per-frame ray records (ref nerf_runner.py:246-316): GL dirs + rgb
        + depth + mask + frame id + type, mask-dilated, invalid-depth culled,
        near/far from the bounding box."""
        cfg = self.cfg
        sc = cfg["sc_factor"]
        mask = self.masks[frame_id, ..., 0].copy().astype(np.uint8)
        dirs = get_camera_rays_np(self.H, self.W, self.K)  # (H,W,3)
        depth = self.depths[frame_id, ..., 0]
        invalid_depth = ((depth < cfg["near"] * sc)
                         | (depth > cfg["far"] * sc)) & (mask > 0)

        down = int(cfg.get("down_scale_ratio", 1))
        # first-frame mask assumed perfect -> big dilation
        k = 100 if frame_id == 0 else max(1, 60 // down)
        mask = dilate_mask(mask, k)
        if self.occ_masks is not None:
            mask[self.occ_masks[frame_id] > 0] = 0
        if cfg["rays_valid_depth_only"]:
            mask[invalid_depth] = 0

        vs, us = np.nonzero(mask > 0)
        if len(vs) == 0:
            return None
        rec = {
            "dirs": dirs[vs, us],
            "rgb": self.images[frame_id][vs, us].astype(np.float32),
            "depth": depth[vs, us].astype(np.float32),
            "mask": (self.masks[frame_id, ..., 0][vs, us] > 0).astype(np.float32),
            "frame_id": np.full(len(vs), frame_id, np.int32),
            "ray_type": np.zeros(len(vs), np.float32),
        }
        # near/far from the scene bounding box, in z-depth units
        bounds = np.array(cfg["bounding_box"], np.float64).reshape(2, 3)
        pose = self.poses[frame_id]
        d_world = rec["dirs"] @ pose[:3, :3].T
        o_world = np.broadcast_to(pose[:3, 3], d_world.shape)
        near, far, hit = ray_box_near_far(o_world, d_world, bounds)
        dz = np.abs(rec["dirs"][:, 2] / np.linalg.norm(rec["dirs"], axis=-1))
        rec["near"] = np.abs(near * dz).astype(np.float32)
        rec["far"] = np.abs(far * dz).astype(np.float32)
        rec = {k: v[hit] for k, v in rec.items()}
        return rec

    @spanned("nof.ray_store")
    def _build_ray_store(self, frame_range=None):
        if frame_range is None:
            frame_range = range(len(self.images))
        recs = [r for i in frame_range
                for r in [self.make_frame_rays(i)] if r is not None]
        rays = {k: np.concatenate([r[k] for r in recs], axis=0)
                for k in recs[0]}

        if self.cfg.get("denoise_depth_use_octree_cloud", True) \
                and self.build_octree_pts is not None:
            # flag rays whose lifted 3D point is far from the scene cloud
            # (ref nerf_runner.py:183-199)
            sc = self.cfg["sc_factor"]
            m = (rays["mask"] > 0) & (rays["depth"] <= self.cfg["far"] * sc)
            pts_cam = rays["dirs"][m] * rays["depth"][m][:, None]
            fids = rays["frame_id"][m]
            P = self.poses[fids]
            pts_w = np.einsum("nij,nj->ni", P[:, :3, :3], pts_cam) + P[:, :3, 3]
            kdtree = cKDTree(self.build_octree_pts)
            dists, _ = kdtree.query(pts_w, k=1, workers=-1)
            bad = dists > 0.02 * sc
            bad_ids = np.nonzero(m)[0][bad]
            keep = np.ones(len(rays["depth"]), bool)
            keep[bad_ids] = False
            rays = {k: v[keep] for k, v in rays.items()}
            logging.info(f"denoise dropped {int((~keep).sum())} rays")

        logging.info(f"ray store: {len(rays['depth'])} rays")
        return rays

    # -- continual learning (ref add_new_frames nerf_runner.py:352-433) ----

    def add_new_frames(self, images, depths, masks, normal_maps, poses,
                       occ_masks=None, new_pcd=None, reuse_weights=False):
        """Append a new keyframe batch and retrain. @images...: only the NEW
        frames (already preprocessed); @poses: ALL frames' normalized GL
        poses (keyframe poses may have moved); @new_pcd: updated normalized
        scene cloud for the occupancy grid."""
        prev_n = len(self.images)
        down = int(self.cfg.get("down_scale_ratio", 1))
        if down != 1:
            images = images[:, ::down, ::down]
            depths = depths[:, ::down, ::down]
            masks = masks[:, ::down, ::down]
            if normal_maps is not None:
                normal_maps = normal_maps[:, ::down, ::down]
            if occ_masks is not None:
                occ_masks = occ_masks[:, ::down, ::down]
        self.images = np.concatenate([self.images, images], axis=0)
        self.depths = np.concatenate([self.depths, depths], axis=0)
        self.masks = np.concatenate([self.masks, masks], axis=0)
        if normal_maps is not None and self.normal_maps is not None:
            self.normal_maps = np.concatenate([self.normal_maps, normal_maps],
                                              axis=0)
        if occ_masks is not None and self.occ_masks is not None:
            self.occ_masks = np.concatenate([self.occ_masks, occ_masks],
                                            axis=0)
        self.poses = np.asarray(poses, np.float64).copy()

        with self._on_stream():
            self.c2w = torch.as_tensor(self.poses, dtype=torch.float32,
                                       device=self.device)
            if new_pcd is not None:
                self.build_octree_pts = voxel_downsample(np.asarray(new_pcd),
                                                         0.005)
                self.occ_grid = self._build_occupancy()

            old = self.field
            self.spec = NofSpec(**{**self.spec.__dict__,
                                   "n_frames": len(self.images)})
            self.field = NofField(self.spec, generator=self.generator,
                                  device=self.device)
            if reuse_weights:
                # keep field weights; per-frame arrays restart except the
                # carried-over feature rows (ref nerf_runner.py:385-397;
                # delta poses are new)
                with torch.no_grad():
                    for k in ("sigma_net", "color_net"):
                        getattr(self.field, k).load_state_dict(
                            getattr(old, k).state_dict())
                    if hasattr(old, "table"):
                        self.field.table.copy_(old.table)
                    if hasattr(old, "feature_array"):
                        self.field.feature_array[:prev_n] = \
                            old.feature_array[:prev_n]
            self.optimizer = make_optimizer(self.field, self.tcfg)
            self.global_step = 0

            new_rays = self._build_ray_store(
                frame_range=range(prev_n, len(self.images)))
            # host mirror: append in numpy, then one upload per column
            self._rays_host = {k: np.concatenate([self._rays_host[k],
                                                  new_rays[k]], axis=0)
                               for k in self._rays_host}
            self._upload_rays()

    # -- training ----------------------------------------------------------

    @property
    def scan_chunk(self) -> int:
        o = int(self.cfg.get("scan_chunk", 0) or 0)
        return o if o > 0 else self.SCAN_CHUNK

    def _train_chunk(self, chunk: int):
        """Dispatch @chunk steps, single-device or data-parallel; metrics
        stay on the device (under DP, queued behind every replica's
        work)."""
        if self.dp_devices is None:
            metrics = train_steps(
                self.field, self.optimizer, self.rays, self.n_rays_valid,
                self.c2w, self.occ_grid, self.global_step, chunk, self.rcfg,
                self.lcfg, self.tcfg, self.N_iters, generator=self.generator,
                graph=self._step_graph)
        else:
            metrics = train_steps_dp(
                self._synced_replicas(), *self._dp_shards(), self.c2w,
                self.occ_grid, self.global_step, chunk, self.rcfg, self.lcfg,
                self.tcfg, self.N_iters)
        self.global_step += chunk
        return metrics

    def _synced_replicas(self):
        """The DP replicas brought to the master (`self.field`,
        `self.optimizer`), built at the first call. Call on the runner's
        stream."""
        if self.dp_replicas is None:
            self.dp_replicas = make_replicas(
                self.field, self.dp_devices, optimizer=self.optimizer,
                stream=self.stream, tcfg=self.tcfg, seed=self._seed)
        else:
            set_master(self.dp_replicas, self.field, self.optimizer,
                       self.tcfg)
        return self.dp_replicas

    def _dp_shards(self):
        """(the ray store's shards, n_valid_local), rebuilt after the
        store changed."""
        if self._dp_rays is None:
            self._dp_rays = shard_rays(self.rays, self.dp_devices,
                                       n_valid=self.n_rays_valid)
        return self._dp_rays

    def train(self, n_steps=None):
        """Run the remaining training steps in chunks of `scan_chunk` (ref
        train nerf_runner.py:855-863); the interval hooks fire between
        chunks. Returns the metrics as host numpy arrays (n_steps,)."""
        n = self.N_iters if n_steps is None else n_steps
        all_metrics = []
        remaining = n
        with self._on_stream():
            while remaining > 0:
                chunk = min(self.scan_chunk, remaining)
                prev_step = self.global_step
                metrics = self._train_chunk(chunk)
                remaining -= chunk
                all_metrics.append(metrics)
                self._interval_hooks(prev_step, metrics)
            names = sorted(all_metrics[0])
            # one device->host pull for all metrics
            with span("nof.pull"):
                host = torch.stack([torch.cat([m[k] for m in all_metrics])
                                    for k in names]).cpu().numpy()
        return {k: host[i] for i, k in enumerate(names)}

    # -- asynchronous training (tracker || NOF overlap) --------------------
    # The reference trains the NOF in a child process while the tracker
    # keeps processing frames, bounded by sync_max_delay
    # (bundlesdf.py:571-582). Here a chunk is queued on the runner's stream
    # without a host wait; its metrics start their copy to pinned memory
    # behind it, and the next chunk is dispatched only once that copy has
    # landed (unless forced). Dispatching a chunk is itself host work in
    # eager PyTorch. Interval hooks (which need host values) are deferred
    # to finish_training().

    def start_training(self, n_steps=None):
        """Begin an asynchronous training batch: dispatch the first chunk
        and return. Drive with poll_training(); complete with
        finish_training()."""
        if self._async is not None:
            raise RuntimeError("a training batch is already running")
        self._async = {"remaining": (self.N_iters if n_steps is None
                                     else n_steps),
                       "pulls": [], "start_step": self.global_step}
        self.poll_training()

    def poll_training(self, max_chunks: int = 2, force: bool = False) -> bool:
        """Dispatch up to @max_chunks further chunks if the card has drained
        the previous one; True when all chunks are dispatched and the last
        one has completed. Waits for the card only if @force (which
        dispatches regardless of readiness)."""
        st = self._async
        if st is None:
            return True
        with self._on_stream():
            for _ in range(max_chunks):
                if st["remaining"] <= 0:
                    break
                if (not force and st["pulls"]
                        and not self._chunk_ready(st["pulls"][-1])):
                    break
                chunk = min(self.scan_chunk, st["remaining"])
                st["pulls"].append(HostPull(self._train_chunk(chunk),
                                            "nof.chunk"))
                st["remaining"] -= chunk
        return (st["remaining"] <= 0
                and (not st["pulls"] or self._chunk_ready(st["pulls"][-1])))

    @staticmethod
    def _chunk_ready(pull) -> bool:
        """The seam the overlap tests replace to hold a chunk in flight."""
        return pull.ready()

    def finish_training(self):
        """Block until the asynchronous batch completes; fire the deferred
        interval hooks; return the metrics as host numpy arrays."""
        st = self._async
        if st is None:
            return None
        while st["remaining"] > 0:
            self.poll_training(max_chunks=10 ** 6, force=True)
        host = [p.get() for p in st["pulls"]]
        metrics = {k: np.concatenate([h[k] for h in host]) for k in host[0]}
        self._async = None
        self._interval_hooks(st["start_step"], metrics)
        return metrics

    @property
    def training_in_flight(self) -> bool:
        return self._async is not None

    def _crossed(self, prev, every):
        return every and every < 10 ** 8 \
            and (prev // every) != (self.global_step // every)

    @spanned("nof.hooks")
    def _interval_hooks(self, prev_step, metrics):
        """Ref nerf_runner.py:744-852: loss print, checkpoint, debug render,
        mesh and pose dumps. @metrics: tensors or host arrays."""
        cfg = self.cfg
        save_dir = cfg.get("save_dir", "")
        if self._crossed(prev_step, cfg.get("i_print", 0)):
            means = {k: float(torch.as_tensor(v).float().mean())
                     for k, v in metrics.items()}
            logging.info(f"Iter {self.global_step}: " + ", ".join(
                f"{k}: {v:.5f}" for k, v in sorted(means.items())))
            self.exp_logger.log_scalars(means, self.global_step)
        if self._crossed(prev_step, cfg.get("i_weights", 0)) and save_dir:
            ckpt = os.path.join(save_dir, "model_latest.npz")
            self.save_weights(ckpt)
            self.exp_logger.add_artifact(ckpt)
        if self._crossed(prev_step, cfg.get("i_img", 0)) and save_dir:
            self._save_debug_render(save_dir)
        if self._crossed(prev_step, cfg.get("i_mesh", 0)) and save_dir:
            mesh = self.extract_mesh()
            if mesh is not None:
                mesh_path = os.path.join(
                    save_dir,
                    f"step_{self.global_step:07d}_mesh_normalized_space.obj")
                mesh.export(mesh_path)
                self.exp_logger.add_artifact(mesh_path)
        if self._crossed(prev_step, cfg.get("i_pose", 0)) and save_dir:
            poses, _ = self.get_optimized_poses_in_real_world()
            np.savetxt(os.path.join(
                save_dir, f"step_{self.global_step:07d}_optimized_poses.txt"),
                poses.reshape(-1, 4))

    def _save_debug_render(self, save_dir):
        """Rendered-vs-GT color panel for the last training frame."""
        fid = len(self.images) - 1
        out, idx = self.render_frame(fid)
        if len(idx) == 0:
            return
        canvas = np.full((self.H, self.W, 3), 128, np.uint8)
        dirs = self._rays_host["dirs"][idx]
        us = np.clip(np.round(dirs[:, 0] / -dirs[:, 2] * self.K[0, 0]
                              + self.K[0, 2]).astype(int), 0, self.W - 1)
        vs = np.clip(np.round(-dirs[:, 1] / -dirs[:, 2] * self.K[1, 1]
                              + self.K[1, 2]).astype(int), 0, self.H - 1)
        canvas[vs, us] = np.clip(out["rgb_map"] * 255, 0, 255).astype(np.uint8)
        gt = np.clip(self.images[fid] * 255, 0, 255).astype(np.uint8)
        os.makedirs(save_dir, exist_ok=True)
        write_png(os.path.join(save_dir,
                               f"image_step_{self.global_step:07d}.png"),
                  np.concatenate([canvas, gt], axis=1))

    # -- feature-match BA in ray space (ref make_key_ray_ids + train_BA
    # nerf_runner.py:866-976): offline pose refinement that pulls the
    # depth-lifted world points of matched rays together ------------------

    def match_table_to_ray_pairs(self, matches_table):
        """Map a {(idA,idB): (N,4) uv matches} table to ray-store index
        pairs by nearest pixel (ref make_key_ray_ids)."""
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        dirs = self._rays_host["dirs"]
        fids = self._rays_host["frame_id"]
        # GL dirs -> pixel coords (ref dirs_to_uvs)
        us = dirs[:, 0] / -dirs[:, 2] * fx + cx
        vs = -dirs[:, 1] / -dirs[:, 2] * fy + cy
        uvs = np.stack([us, vs], -1)

        pairs = []
        for (idA, idB), uv in matches_table.items():
            if uv is None or len(uv) == 0:
                continue
            uv = np.asarray(uv)

            def kpts_to_ray_ids(kpts, fid):
                sel = np.nonzero(fids == fid)[0]
                if len(sel) == 0:
                    return None
                tree = cKDTree(uvs[sel])
                _, ind = tree.query(kpts, k=1, workers=-1)
                return sel[ind]

            ra = kpts_to_ray_ids(uv[:, :2], idA)
            rb = kpts_to_ray_ids(uv[:, 2:4], idB)
            if ra is None or rb is None:
                continue
            pairs.append(np.stack([ra, rb], -1))
        if not pairs:
            return np.zeros((0, 2), np.int64)
        return np.concatenate(pairs, axis=0)

    def train_ba(self, match_ray_ids, n_steps=200, max_dist=0.02):
        """Optimize only the pose corrections so matched rays' depth-lifted
        world points coincide (ref train_BA nerf_runner.py:932-976): Adam
        on a copy of `pose_array`, written back at the end. Returns the
        loss of every step."""
        if len(match_ray_ids) == 0:
            return None
        spec = self.spec
        thresh = max_dist * self.cfg["sc_factor"]
        far = self.lcfg.far
        lr = self.tcfg.lrate_pose or self.tcfg.lrate
        with self._on_stream():
            def gather(k, col, dtype):
                return torch.as_tensor(
                    self._rays_host[k][match_ray_ids[:, col]], dtype=dtype,
                    device=self.device)

            data = {s: {"dirs": gather("dirs", i, torch.float32),
                        "depth": gather("depth", i, torch.float32),
                        "fid": gather("frame_id", i, torch.long)}
                    for i, s in enumerate("ab")}
            pose = self.field.pose_array.detach().clone().requires_grad_()
            opt = torch.optim.Adam([pose], lr=lr, betas=(0.9, 0.999),
                                   eps=1e-15)

            def pts_world(d):
                tf = pose_array_matrices(pose, d["fid"], spec.max_trans,
                                         spec.max_rot_deg) @ self.c2w[d["fid"]]
                pts = d["dirs"] * d["depth"][:, None]
                return (torch.einsum("nij,nj->ni", tf[:, :3, :3], pts)
                        + tf[:, :3, 3])

            valid = (data["a"]["depth"] <= far) & (data["b"]["depth"] <= far)
            losses = []
            for _ in range(n_steps):
                d = torch.linalg.norm(pts_world(data["a"])
                                      - pts_world(data["b"]), dim=-1)
                m = valid & (d < thresh)
                loss = torch.sum(d * m) / torch.clamp(torch.sum(m), min=1)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            with torch.no_grad():
                self.field.pose_array.copy_(pose)
            return torch.stack(losses).cpu().numpy()

    # -- checkpointing (ref save_weights/load_weights nerf_runner.py:528-576)

    def save_weights(self, out_file):
        """One npz with named keys: the params under their JAX names
        (`params/sigma_net/0/w`, in the JAX layout), the Adam moments and
        step of each parameter under its module name, and the step."""
        out = {"global_step": np.asarray(self.global_step)}
        with self._on_stream():
            for k, v in _flatten_jax(params_to_jax(
                    self.field.state_dict())).items():
                out[f"params/{k}"] = v
            for name, p in self.field.named_parameters():
                st = self.optimizer.state.get(p)
                if st:
                    out[f"adam_m/{name}"] = st["exp_avg"].cpu().numpy()
                    out[f"adam_v/{name}"] = st["exp_avg_sq"].cpu().numpy()
                    out[f"adam_step/{name}"] = np.asarray(float(st["step"]))
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        np.savez(out_file, **out)

    def load_weights(self, ckpt_path):
        """Load a checkpoint of `save_weights`, or a JAX `model_latest.npz`
        (its params and Adam moments; per-frame rows past this runner's
        frame count, the JAX package's padding, are dropped)."""
        data = np.load(ckpt_path)
        moments = {}
        if "n_leaves" in data:
            leaves = [data[f"leaf_{i}"] for i in range(int(data["n_leaves"]))]
            params, mu, nu, count = self._from_jax_leaves(leaves)
            for tag, tree in (("adam_m", mu), ("adam_v", nu)):
                moments[tag] = self._fit_frames(params_from_jax(tree))
            moments["adam_step"] = {k: count for k in moments["adam_m"]}
        else:
            params = _unflatten_jax({k[len("params/"):]: data[k]
                                     for k in data.files
                                     if k.startswith("params/")})
            for tag in ("adam_m", "adam_v", "adam_step"):
                moments[tag] = {k[len(tag) + 1:]: torch.as_tensor(data[k])
                                for k in data.files
                                if k.startswith(tag + "/")}
        with self._on_stream():
            self.field.load_state_dict(self._fit_frames(
                params_from_jax(params)))
            self.optimizer = make_optimizer(self.field, self.tcfg)
            for name, p in self.field.named_parameters():
                if name in moments["adam_m"]:
                    self.optimizer.state[p] = {
                        "step": torch.tensor(
                            float(moments["adam_step"][name])),
                        "exp_avg": moments["adam_m"][name].to(p.device),
                        "exp_avg_sq": moments["adam_v"][name].to(p.device)}
        self.global_step = int(data["global_step"])

    def _fit_frames(self, sd):
        """Cut per-frame rows to this runner's frame count."""
        return {k: (v[:self.spec.n_frames]
                    if k in ("pose_array", "feature_array") else v)
                for k, v in sd.items()}

    def _from_jax_leaves(self, leaves):
        """(params, adam mu, adam nu, adam count) from the leaves of the
        JAX package's `{"opt_state": scale_by_adam state, "params": ...}`
        checkpoint, in jax's flatten order: dict keys sorted, the adam
        state as (count, mu, nu)."""
        keys = []
        for k in sorted(["color_net", "pose_array", "sigma_net"]
                        + (["table"] if self.spec.i_embed == 1 else [])
                        + (["feature_array"] if self.spec.frame_features > 0
                           else [])):
            if k in ("color_net", "sigma_net"):
                n = (self.spec.num_layers_color if k == "color_net"
                     else self.spec.num_layers_sigma)
                keys += [f"{k}/{i}/{w}" for i in range(n) for w in "bw"]
            else:
                keys.append(k)
        n = len(keys)
        if len(leaves) != 1 + 3 * n:
            raise ValueError(f"JAX checkpoint has {len(leaves)} leaves; this "
                             f"runner's params and Adam state need {1 + 3 * n}")
        trees = [_unflatten_jax(dict(zip(keys, leaves[1 + i * n:1 + (i + 1) * n])))
                 for i in range(3)]
        return trees[2], trees[0], trees[1], float(leaves[0])

    def copy_from(self, other, ignore=()):
        """Warm-start field weights from another runner
        (ref copy_from nerf_runner.py:507-525): shared nets copied, the
        per-frame arrays keep their first len(other) rows."""
        n_other = min(len(other.images), len(self.images))
        with self._on_stream(), torch.no_grad():
            if self.stream is not None and other.stream is not None:
                self.stream.wait_stream(other.stream)
            for k in ("table", "sigma_net", "color_net"):
                if k not in ignore and hasattr(other.field, k):
                    if k == "table":
                        self.field.table.copy_(other.field.table)
                    else:
                        getattr(self.field, k).load_state_dict(
                            getattr(other.field, k).state_dict())
            for k in ("pose_array", "feature_array"):
                if (k not in ignore and hasattr(self.field, k)
                        and hasattr(other.field, k)):
                    getattr(self.field, k)[:n_other] = \
                        getattr(other.field, k)[:n_other]
            self.optimizer = make_optimizer(self.field, self.tcfg)

    # -- outputs -----------------------------------------------------------

    def extract_mesh(self, voxel_size=None, isolevel=0.0):
        """Dense SDF grid -> marching tetrahedra (ref extract_mesh
        nerf_runner.py:1351-1409). Occupancy-culled queries, in chunks of
        2^18 points in float32; non-occupied cells get SDF=1."""
        cfg = self.cfg
        voxel_size = (cfg["mesh_resolution"] if voxel_size is None
                      else voxel_size) * cfg["sc_factor"]
        bounds = np.array(cfg["bounding_box"], np.float64).reshape(2, 3)
        tx = np.arange(bounds[0, 0] + 0.5 * voxel_size, bounds[1, 0], voxel_size)
        ty = np.arange(bounds[0, 1] + 0.5 * voxel_size, bounds[1, 1], voxel_size)
        tz = np.arange(bounds[0, 2] + 0.5 * voxel_size, bounds[1, 2], voxel_size)
        query = np.stack(np.meshgrid(tx, ty, tz, indexing="ij"), -1)
        shape = query.shape[:3]
        sigma = np.ones(int(np.prod(shape)), np.float32)
        with self._on_stream(), torch.no_grad():
            flat = torch.as_tensor(query.reshape(-1, 3), dtype=torch.float32,
                                   device=self.device)
            vi = torch.nonzero(query_occupancy(self.occ_grid, flat))[:, 0]
            chunk = 2 ** 18
            vals = [self.field.sdf(flat[vi[s:s + chunk]])
                    for s in range(0, len(vi), chunk)]
            if vals:
                sigma[vi.cpu().numpy()] = torch.cat(vals).cpu().numpy()
        sigma = sigma.reshape(shape)

        verts, faces = marching_tetrahedra(sigma, isolevel)
        if len(faces) == 0:
            logging.info("extract_mesh: empty surface")
            return None
        # index coords -> normalized space
        offset = np.array([tx[0], ty[0], tz[0]])
        verts = verts * voxel_size + offset
        self.mesh = Mesh(verts, faces)
        return self.mesh

    def get_optimized_poses_in_real_world(self):
        """Apply pose corrections, undo normalization, anchor to frame 0,
        convert GL->CV (ref `get_optimized_poses_in_real_world`
        Utils.py:479-505). Host numpy; only the (F,6) pose params come from
        the device. Returns (poses (F,4,4) cv cam-in-object, offset)."""
        sc = self.cfg["sc_factor"]
        translation = np.asarray(self.cfg["translation"]).reshape(3)
        poses_norm = self.poses.copy()

        original = poses_norm.copy()
        original[:, :3, 3] /= sc
        original[:, :3, 3] -= translation

        with self._on_stream():
            pose_params = self.field.pose_array.detach().cpu().numpy()
        theta = np.tanh(pose_params.astype(np.float64)[:len(poses_norm)])
        tau = np.concatenate([theta[:, :3] * self.spec.max_trans,
                              theta[:, 3:6] * (self.spec.max_rot_deg
                                               / 180.0 * np.pi)], axis=-1)
        tf = se3_exp_np(tau)
        tf[0] = np.eye(4)  # frame 0 pinned (PoseArray semantics)
        optimized = tf @ poses_norm
        optimized[:, :3, 3] /= sc
        optimized[:, :3, 3] -= translation

        offset = np.linalg.inv(optimized[0]) @ original[0]
        out = np.einsum("nij,jk->nik", optimized, offset)
        out = out @ GLCAM_IN_CVCAM
        return out.astype(np.float32), offset

    def mesh_to_real_world(self, mesh: Mesh, pose_offset=None):
        """Undo normalization on mesh vertices (ref `mesh_to_real_world`
        Utils.py:508-514)."""
        if pose_offset is None:
            pose_offset = np.eye(4)
        sc = self.cfg["sc_factor"]
        translation = np.asarray(self.cfg["translation"]).reshape(3)
        mesh.vertices = mesh.vertices / sc - translation
        mesh.apply_transform(pose_offset)
        return mesh

    def render_frame(self, frame_id, max_rays=2 ** 16):
        """Render all rays of one training frame without jitter (debug/eval;
        ref render_images nerf_runner.py:586-640). Returns (dict of host
        arrays, ray indices)."""
        idx = np.nonzero(self._rays_host["frame_id"] == frame_id)[0]
        outs = {"rgb_map": [], "depth_pred": []}
        with self._on_stream(), torch.no_grad():
            for s in range(0, len(idx), max_rays):
                sel = torch.as_tensor(idx[s:s + max_rays], device=self.device)
                batch = {k: v[sel] for k, v in self.rays.items()}
                # a fixed seed, as the JAX package's PRNGKey(0): only
                # raw_noise_std > 0 draws from it
                out = render_rays(self.field, self.rcfg, batch, self.c2w,
                                  self.occ_grid, perturb=False,
                                  generator=torch.Generator(
                                      device=self.device).manual_seed(0))
                outs["rgb_map"].append(out["rgb_map"].cpu().numpy())
                outs["depth_pred"].append(torch.sum(
                    out["weights"] * out["z_vals"], dim=-1).cpu().numpy())
        return {k: np.concatenate(v) if v else np.zeros((0,))
                for k, v in outs.items()}, idx


def _flatten_jax(tree, prefix=""):
    """{"sigma_net": [{"w": a}]} -> {"sigma_net/0/w": a}."""
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten_jax(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_jax(flat):
    """Inverse of `_flatten_jax` for the NOF parameter tree: the nets are
    lists of layers."""
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        if len(parts) == 1:
            tree[key] = v
        else:
            net, i, w = parts
            layers = tree.setdefault(net, [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)][w] = v
    return tree
