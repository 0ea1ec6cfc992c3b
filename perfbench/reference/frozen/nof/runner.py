"""NofRunner -- per-video Neural Object Field trainer, the synchronous
path only.

Port of `bundlesdf_tpu/nof/runner.py` (the re-design of the reference
`NerfRunner`, `nerf_runner.py:112-433`): same inputs (normalized keyframe
images/depths/masks/normals + GL poses + a point cloud for the occupancy
grid), same outputs (optimized poses). Ray construction happens once on
the host in numpy; the ray store is a dict of device tensors, with a host
mirror that continual batches extend (`add_new_frames`). Training is
eager PyTorch in chunks of `scan_chunk` steps through `train`, on the
current stream. The port's asynchronous batches, its CUDA stream, data
parallelism, interval hooks, checkpoints, meshes and renders are left out
of the frozen copy: no cell's comparison reaches them.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from perfbench.reference.frozen import resolve_device
from perfbench.reference.frozen.nof.losses import LossConfig
from perfbench.reference.frozen.nof.models import NofField, NofSpec
from perfbench.reference.frozen.nof.render import RenderConfig
from perfbench.reference.frozen.nof.train import (TrainConfig, make_optimizer,
                                           train_steps)
from perfbench.reference.frozen.ops.hashgrid import HashGridSpec
from perfbench.reference.frozen.ops.occupancy import (OccupancyGrid,
                                               build_occupancy_grid)
from perfbench.reference.frozen.scene.bounds import voxel_downsample
from perfbench.reference.frozen.utils.common import (BAD_COLOR, BAD_DEPTH,
                                              GLCAM_IN_CVCAM)
from perfbench.reference.frozen.utils.se3 import se3_exp_np


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
    """

    # steps a chunk dispatches (the JAX package's scan chunk)
    SCAN_CHUNK = 50

    def __init__(self, cfg, images, depths, masks, normal_maps, poses, K,
                 occ_masks=None, build_octree_pts=None, seed=0,
                 device="cuda"):
        self.cfg = cfg
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.images = np.asarray(images)
        self.depths = np.asarray(depths)
        self.masks = np.asarray(masks)
        self.normal_maps = None if normal_maps is None else np.asarray(normal_maps)
        self.occ_masks = None if occ_masks is None else np.asarray(occ_masks)
        self.poses = np.asarray(poses, np.float64)
        self.K = np.asarray(K, np.float64).copy()
        self.build_octree_pts = (None if build_octree_pts is None
                                 else np.asarray(build_octree_pts))
        self.global_step = 0
        self.N_iters = cfg["n_step"] + 1

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

        # one generator drives init, batch draws and sample jitter
        self.generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.field = NofField(self.spec, generator=self.generator,
                              device=self.device)
        self.optimizer = make_optimizer(self.field, self.tcfg)
        self.c2w = torch.as_tensor(self.poses, dtype=torch.float32,
                                   device=self.device)
        self._rays_host = self._build_ray_store()
        self._upload_rays()

    def _upload_rays(self):
        """Device ray store from the host mirror: one upload per column.
        float64 host columns (the ray dirs) become float32 on the device,
        as jax's default 32-bit mode does in the JAX package."""
        self.n_rays_valid = int(self._rays_host["depth"].shape[0])
        self.rays = {k: torch.as_tensor(np.ascontiguousarray(
            v.astype(np.float32) if v.dtype == np.float64 else v),
            device=self.device) for k, v in self._rays_host.items()}

    # -- dataset -----------------------------------------------------------

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
        """Dispatch @chunk steps; metrics stay on the device."""
        metrics = train_steps(
            self.field, self.optimizer, self.rays, self.n_rays_valid,
            self.c2w, self.occ_grid, self.global_step, chunk, self.rcfg,
            self.lcfg, self.tcfg, self.N_iters, generator=self.generator)
        self.global_step += chunk
        return metrics

    def train(self, n_steps=None):
        """Run the remaining training steps in chunks of `scan_chunk` (ref
        train nerf_runner.py:855-863). Returns the metrics as host numpy arrays (n_steps,)."""
        n = self.N_iters if n_steps is None else n_steps
        all_metrics = []
        remaining = n
        while remaining > 0:
            chunk = min(self.scan_chunk, remaining)
            metrics = self._train_chunk(chunk)
            remaining -= chunk
            all_metrics.append(metrics)
        names = sorted(all_metrics[0])
        # one device->host pull for all metrics
        host = torch.stack([torch.cat([m[k] for m in all_metrics])
                            for k in names]).cpu().numpy()
        return {k: host[i] for i, k in enumerate(names)}

    # -- outputs -----------------------------------------------------------

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

