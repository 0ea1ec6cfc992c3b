"""BundleSdf orchestrator: the per-frame tracking pipeline plus Neural
Object Field (NOF) batches with pose sync-back, the synchronous path only.

Port of `bundlesdf_tpu/bundlesdf.py` (ref `bundlesdf.py:266-766`):
`BundleSdf(cfg_track=..., cfg_nerf=..., device=...).run(color, depth, K,
id_str, mask, occ_mask, pose_in_model)` once per frame. Frame k's BA
result is pulled, and its keyframe admission done, at the start of frame
k+1, after frame k+1's depth chain and feature detection are issued
(`async_pipeline`).

From `start_nerf_keyframes` keyframes on, each keyframe batch builds or
extends a `NofRunner` (continual: `add_new_frames`) and its optimized
poses are synced back into the keyframes (`nerfed`, which pins them in
the BA), within the `run` call whose keyframe completes the batch: strict
sync (`sync_max_delay` 0). What trains a batch is a seam, `NofBatches`:
by default the whole batch through `NofRunner.train` and the runner's own
poses synced back; a caller may pass its own. The port's worker thread,
asynchronous batches, artifacts, GUI, meshes and offline refine are left
out of the frozen copy: no cell's comparison reaches them.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import os

import numpy as np

from perfbench.reference.frozen import resolve_device
from perfbench.reference.frozen.matcher.classical import OrbMatcher
from perfbench.reference.frozen.nof.runner import NofRunner, preprocess_frame_data
from perfbench.reference.frozen.scene.bounds import (compute_scene_bounds,
                                              compute_scene_bounds_frame,
                                              find_biggest_cluster,
                                              voxel_downsample)
from perfbench.reference.frozen.tracker.bundler import Bundler
from perfbench.reference.frozen.tracker.frame import Frame, FrameStatus
from perfbench.reference.frozen.utils.common import (GLCAM_IN_CVCAM,
                                              geodesic_distance_np,
                                              resize_nearest)


class NofBatches:
    """The seam that trains each NOF batch: @before sees the runner (None
    before the first batch) as the batch begins, @train gets the batch's
    built or extended runner and returns the poses to sync back, or None
    for the runner's own. By default the whole batch trains through
    `NofRunner.train`."""

    def before(self, runner, k: int):
        pass

    def train(self, runner, k: int):
        runner.train()
        return None


class BundleSdf:
    def __init__(self, cfg_track, cfg_nerf, start_nerf_keyframes=5,
                 matcher=None, device="cuda", nof_batches=None):
        """@cfg_track/@cfg_nerf: the configuration dicts (reference
        schemas). @device: where the frame pool, matching, RANSAC and BA
        run: the card unless "cpu". @nof_batches: the `NofBatches` that
        trains each batch."""
        self.cfg_track = cfg_track
        self.cfg_nerf = cfg_nerf
        self.device = resolve_device(device)
        self.start_nerf_keyframes = start_nerf_keyframes
        if int(self.cfg_nerf.get("sync_max_delay", 0)) != 0:
            raise NotImplementedError(
                "the frozen reference runs strict sync only")
        self.nof_batches = nof_batches or NofBatches()
        if matcher is not None:
            self.matcher = matcher
        else:
            # LoFTR drives the pipeline when a checkpoint is configured
            # (ref loftr_wrapper.py + readme.md:30-31); ORB is the
            # weights-free fallback
            ckpt = self.cfg_track.get("loftr_ckpt", "")
            if ckpt and os.path.exists(ckpt):
                # bf16 inference by default, as the reference wrapper runs
                # the net under autocast (loftr_wrapper.py:43-56)
                raise NotImplementedError(
                    "the frozen reference carries the ORB matcher only")
            else:
                self.matcher = OrbMatcher(device=self.device)
        self.bundler = Bundler(self.cfg_track, self.matcher,
                               device=self.device)
        fc_cfg = self.cfg_track["feature_corres"]
        # the fused matcher is the default on the card; the CPU keeps the
        # batched-matcher -> lift+RANSAC split unless the config asks
        self.fused = bool(fc_cfg.get("fused_matcher",
                                     self.device.type == "cuda"))
        # the fused matcher evaluates the non-neighbor covisibility gate
        # inside its own call: get_feature_match_pairs defers unknown pairs
        # to it instead of computing them separately
        self.bundler._defer_covis_gate = bool(
            self.fused and not fc_cfg.get("map_points", False)
            and hasattr(self.matcher, "_frame_feats"))
        self.K = None
        self.cnt = -1

        # cross-frame pipelining: frame k's BA pull + admission + artifact
        # writes are deferred until frame k+1's preprocess/detect have been
        # issued. Frame state (pose, status, keyframe admission, saved
        # artifacts) is FINAL once the next run() call starts processing,
        # or after flush_pipeline()/on_finish(). Disable with
        # cfg_track["async_pipeline"]=False for strictly synchronous
        # per-frame semantics.
        self.async_pipeline = bool(self.cfg_track.get("async_pipeline",
                                                      True))
        self._deferred = None  # (frame, pending BA)

        # NOF side state (replaces the run_nerf child, bundlesdf.py:64-260)
        self.nerf: NofRunner | None = None
        self.kf_to_nerf_list: list[dict] = []
        self.nerf_num_frames = 0
        self.cnt_nerf = -1
        self.prev_pcd_real_scale = None
        self.translation = None
        self.sc_factor = None
        self.n_batches = 0

    @staticmethod
    def _stage(name: str):
        """The port times its stages here; the frozen copy does not."""
        return contextlib.nullcontext()

    # ------------------------------------------------------------------
    def make_frame(self, color, depth, K, id_str, mask=None, occ_mask=None,
                   pose_in_model=np.eye(4)):
        self.cnt += 1
        H, W = np.asarray(color).shape[:2]
        pool = self.bundler.ensure_pool(H, W)
        return Frame(color, depth, K, self.cnt, id_str, self.cfg_track,
                     mask=mask, occ_mask=occ_mask, pose_in_model=pose_in_model,
                     pool=pool)

    # ------------------------------------------------------------------
    # find_corres (ref bundlesdf.py:352-387)
    # ------------------------------------------------------------------
    def find_corres(self, frame_pairs):
        b = self.bundler
        if not frame_pairs:
            return
        is_match_ref = (len(frame_pairs) == 1
                        and frame_pairs[0][0].ref_frame_id
                        == frame_pairs[0][1].id
                        and b.new_frame is frame_pairs[0][0])
        # map-point propagation augments net matches with multi-frame
        # tracks (ref findCorresByMapPoints, feature_corres.map_points)
        use_map_points = self.cfg_track["feature_corres"].get("map_points",
                                                              False)
        min_match_with_ref = \
            self.cfg_track["feature_corres"]["min_match_with_ref"]
        if (self.fused and not use_map_points
                and hasattr(self.matcher, "_frame_feats")):
            # ORB match + lift + gate + RANSAC on the device, one host pull
            n_raw = b.match_pairs_fused(frame_pairs, self.matcher)
            if is_match_ref and n_raw[0] < min_match_with_ref:
                b.new_frame.status = FrameStatus.FAIL
                logging.info(
                    f"frame {b.new_frame.id_str} FAIL: no matching")
            return
        if hasattr(self.matcher, "match_frames"):
            # frame-keyed path (ORB): descriptors cached per frame, matched
            # at full res, no per-pair warp
            raw = self.matcher.match_frames(frame_pairs)
        else:
            # canonicalize each pair: rotate B into A's in-plane
            # orientation, crop the ROIs, resize to a shared square (ref
            # getProcessedImagePairs -> processImagePair
            # FeatureManager.cpp:126-257), all pairs in one warp on the
            # matcher's device
            raise NotImplementedError(
                "the frozen reference carries the ORB matcher only")

        if use_map_points:
            merged = []
            for (fA, fB), uv in zip(frame_pairs, raw):
                prop = b.propagate_matches(fA, fB)
                if len(prop):
                    uv = np.concatenate(
                        [np.asarray(uv).reshape(-1, uv.shape[1]
                                                if len(uv) else 5), prop],
                        axis=0)
                merged.append(uv)
            raw = merged

        if is_match_ref and len(raw[0]) < min_match_with_ref:
            b.new_frame.status = FrameStatus.FAIL
            logging.info(f"frame {b.new_frame.id_str} FAIL: no matching")
            return
        b.match_pairs(frame_pairs, raw)
        if use_map_points:
            for fA, fB in frame_pairs:
                b.update_map_points(fA, fB)

    # ------------------------------------------------------------------
    # per-frame pipeline (ref process_new_frame bundlesdf.py:391-506)
    # ------------------------------------------------------------------
    def process_new_frame(self, frame: Frame):
        b = self.bundler
        b.new_frame = frame
        b._covis_gate_pending = set()
        cfg = self.cfg_track

        if frame.id > 0:
            ref_frame = b.frames[list(b.frames.keys())[-1]]
            frame.ref_frame_id = ref_frame.id
            frame.pose_in_model = ref_frame.pose_in_model.copy()
        else:
            b.first_frame = frame

        # the mask was applied inside the depth chain at construction;
        # re-invalidation only happens when the mask shrinks
        # (point_cloud_denoise below)
        if frame.id == 0 and np.abs(frame.pose_in_model
                                    - np.eye(4)).max() <= 1e-4:
            frame.set_new_init_coordinate()

        n_fg = int((frame.fg_mask > 0).sum())
        if n_fg < 100:
            logging.info(f"frame {frame.id_str} empty mask, FAIL "
                         f"(n_fg={n_fg})")
            frame.status = FrameStatus.FAIL
            b.forget_frame(frame)
            return

        if cfg["depth_processing"].get("denoise_cloud", False):
            frame.point_cloud_denoise()

        # host feature detection runs before the valid-count wait: it
        # hides the device->host transfer started at preprocess time
        if hasattr(self.matcher, "_frame_feats"):
            self.matcher._frame_feats(frame)

        with self._stage("valid_pull"):
            n_valid = frame.count_valid_points()
        n_valid_first = b.first_frame.count_valid_points()
        if n_valid < n_valid_first / 40.0:
            logging.info(f"frame {frame.id_str} too few valid points "
                         f"({n_valid} vs first {n_valid_first}), FAIL")
            frame.status = FrameStatus.FAIL
            b.forget_frame(frame)
            return

        if frame.id == 0:
            b.check_and_add_keyframe(frame)
            b.frames[frame.id] = frame
            return

        min_match_with_ref = cfg["feature_corres"]["min_match_with_ref"]
        # arm the ref-match fusion: device procrustes + window-selection
        # covisibility ride the ref-match call whenever the selection will
        # need covisibility scores
        b._covis_seed = None
        max_ba = cfg["bundle"]["max_BA_frames"]
        sel_method = cfg["bundle"].get("subset_selection_method",
                                       "normal_orientation_nearest")
        if (len(b.keyframes) + 1 > max_ba
                and sel_method == "normal_orientation_nearest"
                and getattr(b, "_defer_covis_gate", False)):
            b._sel_ctx = {
                "kfs": list(b.keyframes),
                "extra_pairs": b._unscored_kf_pairs(list(b.keyframes))}
        with self._stage("ref_match"):
            self.find_corres([(frame, ref_frame)])
        if frame.status == FrameStatus.FAIL:
            b.forget_frame(frame)
            return
        rres = getattr(b, "_ref_match_result", None)

        # re-localize against the keyframe pool by covisibility if the ref
        # match failed (ref bundlesdf.py:443-471)
        if b.n_matches(frame, ref_frame) < min_match_with_ref:
            rres = None  # fused offset/covis were for the failed ref pose
            with self._stage("relocalize"):
                visibles = b.covisibility_many(frame, b.keyframes)
                found = False
                for idx in np.argsort(visibles)[::-1]:
                    kf = b.keyframes[idx]
                    logging.info(f"trying new ref frame {kf.id_str}")
                    ref_frame = kf
                    frame.ref_frame_id = kf.id
                    frame.pose_in_model = kf.pose_in_model.copy()
                    self.find_corres([(frame, kf)])
                    if b.n_matches(frame, kf) >= min_match_with_ref:
                        logging.info(f"re-chose ref frame {kf.id_str}")
                        found = True
                        break
            if not found:
                frame.status = FrameStatus.FAIL
                logging.info(f"frame {frame.id_str} no suitable ref, FAIL")
                b.forget_frame(frame)
                return

        if rres is not None and rres["pair"] == (frame.id, ref_frame.id):
            # device procrustes from the fused ref-match call; its guards
            # (count, degeneracy, neighbor residual) collapsed the offset to
            # identity whenever the host logic would have
            offset = rres["offset"]
            if not rres["use"]:
                logging.info(
                    f"procrustes {frame.id_str}-{ref_frame.id_str}: device "
                    f"guards rejected pose (err={rres['err']:.5f}), identity")
            b._covis_seed = rres["covis"]
        else:
            offset = b.procrustes(frame, ref_frame)
        frame.pose_in_model = offset @ frame.pose_in_model

        # window eviction (ref bundlesdf.py:479-487)
        window_size = cfg["bundle"]["window_size"]
        if len(b.frames) - len(b.keyframes) > window_size:
            for fid in list(b.frames.keys()):
                if b.forget_frame(b.frames[fid]):
                    logging.info(f"window full, forget {fid}")
                    break

        b.frames[frame.id] = frame
        b.select_keyframes_for_ba()
        pairs = b.get_feature_match_pairs(b.local_frames)
        with self._stage("window_match"):
            self.find_corres(pairs)
        if frame.status == FrameStatus.FAIL:
            b.forget_frame(frame)
            return

        with self._stage("ba_dispatch"):
            pending = b.optimize_dispatch(b.local_frames)
        if frame.status == FrameStatus.FAIL:  # zero global corres
            b.forget_frame(frame)
            return None
        if self.async_pipeline and pending is not None:
            # BA pull + jump rejection + keyframe admission deferred to
            # the next run() call (or flush_pipeline)
            return pending
        if pending is not None:
            b.optimize_finish(pending)
        if frame.status == FrameStatus.FAIL:
            b.forget_frame(frame)
            return None

        b.check_and_add_keyframe(frame)
        return None

    # ------------------------------------------------------------------
    # main entry (ref run bundlesdf.py:510-632)
    # ------------------------------------------------------------------
    def run(self, color, depth, K, id_str, mask=None, occ_mask=None,
            pose_in_model=np.eye(4)):
        """@color: (H,W,3) RGB uint8; @depth: (H,W) float32 meters."""
        # whole-pipeline downscale (ref config_behave.yml
        # image_down_scale: frames and intrinsics shrink before tracking)
        down = int(self.cfg_track.get("image_down_scale", 1))
        if down > 1:
            H0, W0 = np.asarray(color).shape[:2]
            size = (W0 // down, H0 // down)
            color = resize_nearest(color, size)
            depth = resize_nearest(np.asarray(depth, np.float32), size)
            if mask is not None:
                mask = resize_nearest(mask, size)
            if occ_mask is not None:
                occ_mask = resize_nearest(occ_mask, size)
            K = np.asarray(K, np.float64).copy()
            K[0] *= size[0] / W0
            K[1] *= size[1] / H0

        if self.K is None:
            self.K = np.asarray(K, np.float64)
        depth = np.asarray(depth, np.float32).copy()
        with self._stage("preprocess"):
            percentile = self.cfg_track["depth_processing"]["percentile"]
            if percentile < 100:
                valid = (depth >= 0.1) & (np.asarray(mask) > 0)
                if valid.any():
                    thres = np.percentile(depth[valid], percentile)
                    depth[depth >= thres] = 0

            frame = self.make_frame(color, depth, K, id_str, mask, occ_mask,
                                    pose_in_model)
        # host feature detection runs now, overlapping the previous frame's
        # BA on the device (skipped when denoise_cloud may still shrink the
        # mask — detection must see the final mask)
        if (hasattr(self.matcher, "_frame_feats")
                and not self.cfg_track["depth_processing"].get(
                    "denoise_cloud", False)
                and int((frame.fg_mask > 0).sum()) >= 100):
            with self._stage("detect"):
                self.matcher._frame_feats(frame)
        with self._stage("ba_finish_prev"):
            self.flush_pipeline()
        pending = self.process_new_frame(frame)
        if pending is not None:
            self._deferred = (frame, pending)
        else:
            with self._stage("finalize"):
                self._finalize_frame(frame)
        return frame

    def flush_pipeline(self):
        """Finish the previous frame's deferred BA: pull optimized poses,
        apply jump rejection + keyframe admission, write artifacts. Called
        automatically at the start of the next run() and from
        on_finish()."""
        if self._deferred is None:
            return
        frame, pending = self._deferred
        self._deferred = None
        b = self.bundler
        b.optimize_finish(pending)
        if frame.status == FrameStatus.FAIL:
            b.forget_frame(frame)
        else:
            b.check_and_add_keyframe(frame)
        self._finalize_frame(frame)

    def _finalize_frame(self, frame):
        """Post-BA per-frame tail: NOF keyframe feed, and in strict sync a
        whole batch with its pose sync-back (ref bundlesdf.py:546-632)."""
        if self.bundler.keyframes and self.bundler.keyframes[-1] is frame:
            self.kf_to_nerf_list.append({
                "rgb": frame.color.copy(),
                "depth": frame.depth.copy(),
                "mask": (frame.fg_mask > 0).astype(np.uint8),
                "occ_mask": frame.occ_mask,
                "normal_map": None,
            })
            ready = (self.cnt_nerf >= 0
                     or len(self.kf_to_nerf_list) >= self.start_nerf_keyframes)
            if ready:
                self._run_nerf_batch()

    # ------------------------------------------------------------------
    # NOF batch (ref run_nerf bundlesdf.py:64-260, continual branch)
    # ------------------------------------------------------------------
    def _run_nerf_batch(self):
        self.n_batches += 1
        batch = self.kf_to_nerf_list
        self.kf_to_nerf_list = []
        self.nerf_num_frames += len(batch)
        self.cnt_nerf += 1
        first = self.cnt_nerf == 0
        cam_in_obs = np.array([kf.pose_in_model for kf in
                               self.bundler.keyframes])
        self.nof_batches.before(self.nerf, self.cnt_nerf)
        self._nerf_batch_body(batch, cam_in_obs, first)
        self._sync_poses_from_nerf(
            self.nof_batches.train(self.nerf, self.cnt_nerf))

    def _nerf_batch_body(self, batch, cam_in_obs, first):
        """Batch prep: scene bounds, preprocessing and the runner built or
        extended (ref run_nerf child body)."""
        rgbs = np.array([f["rgb"] for f in batch])
        depths = np.array([f["depth"] for f in batch])
        masks = np.array([f["mask"] for f in batch])
        occ = [f["occ_mask"] for f in batch]
        occ_masks = (np.array(occ) if all(o is not None for o in occ) and occ
                     else None)

        glcam_in_obs = cam_in_obs @ GLCAM_IN_CVCAM
        cfg_nerf = self.cfg_nerf

        if first:
            sc_factor, translation, pcd_all, _ = compute_scene_bounds(
                rgbs, depths, masks, glcam_in_obs, self.K,
                use_mask=True, eps=cfg_nerf["dbscan_eps"],
                min_samples=cfg_nerf["dbscan_eps_min_samples"])
            sc_factor *= 0.7  # whole object within bounds (ref :151)
            self.sc_factor = float(sc_factor)
            self.translation = translation
            cfg_nerf["sc_factor"] = self.sc_factor
            cfg_nerf["translation"] = np.asarray(self.translation)
        else:
            pcd_all = self.prev_pcd_real_scale
            for i in range(len(rgbs)):
                gl = glcam_in_obs[len(glcam_in_obs) - len(rgbs) + i]
                pts = compute_scene_bounds_frame(depths[i], masks[i], gl,
                                                 self.K)
                if pts is not None:
                    pcd_all = np.concatenate([pcd_all, pts], axis=0)
            pcd_all = voxel_downsample(pcd_all, 0.01)
            _, keep = find_biggest_cluster(
                pcd_all, eps=cfg_nerf["dbscan_eps"],
                min_samples=cfg_nerf["dbscan_eps_min_samples"])
            pcd_all = pcd_all[keep]

        tf_norm = np.eye(4)
        tf_norm[:3, 3] = np.asarray(self.translation)
        tf1 = np.eye(4)
        tf1[:3, :3] *= self.sc_factor
        tf_norm = tf1 @ tf_norm
        pcd_norm = pcd_all @ tf_norm[:3, :3].T + tf_norm[:3, 3]
        pcd_norm = np.clip(pcd_norm, -1, 1)

        # preprocess the NEW batch's images but ALL keyframe poses (the ref
        # passes all poses so moved keyframes reset, bundlesdf.py:185,223)
        rgbs_p, depths_p, masks_p, normals_p, poses_all = preprocess_frame_data(
            rgbs, depths, masks, None, glcam_in_obs.copy(),
            self.sc_factor, np.asarray(self.translation))

        if first or not cfg_nerf["continual"]:
            self.nerf = NofRunner(
                copy.deepcopy(cfg_nerf), rgbs_p, depths_p, masks_p,
                normals_p, poses_all, self.K, occ_masks=occ_masks,
                build_octree_pts=pcd_norm, device=self.device)
        else:
            self.nerf.add_new_frames(rgbs_p, depths_p, masks_p, normals_p,
                                     poses_all, occ_masks=occ_masks,
                                     new_pcd=pcd_norm, reuse_weights=False)
        self.prev_pcd_real_scale = voxel_downsample(pcd_all, 0.01)

    def _sync_poses_from_nerf(self, optimized=None):
        """Overwrite keyframe poses with NOF-optimized poses (@optimized, or
        the runner's) and mark them nerfed (ref bundlesdf.py:587-617)."""
        if optimized is None:
            optimized, _ = self.nerf.get_optimized_poses_in_real_world()
        rematch = self.cfg_track["feature_corres"]["rematch_after_nerf"]
        frames_large_update = []
        for i in range(min(len(optimized), len(self.bundler.keyframes))):
            kf = self.bundler.keyframes[i]
            if rematch:
                trans_up = np.linalg.norm(optimized[i][:3, 3]
                                          - kf.pose_in_model[:3, 3])
                rot_up = geodesic_distance_np(optimized[i][:3, :3],
                                              kf.pose_in_model[:3, :3])
                if trans_up >= 0.005 or rot_up >= np.deg2rad(5):
                    frames_large_update.append(kf)
            kf.pose_in_model = optimized[i].astype(np.float64)
            kf.nerfed = True
        if rematch and frames_large_update:
            ids = {f.id for f in frames_large_update}
            for key in [k for k in self.bundler.matches
                        if k[0] in ids or k[1] in ids]:
                del self.bundler.matches[key]

