"""BundleSdf orchestrator: the per-frame tracking pipeline plus concurrent
Neural Object Field (NOF) training with pose sync-back.

Port of `bundlesdf_tpu/bundlesdf.py` (ref `bundlesdf.py:266-766`):
`BundleSdf(cfg_track=..., cfg_nerf=..., device=...).run(color, depth, K,
id_str, mask, occ_mask, pose_in_model)` once per frame, then `on_finish()`.
Frame k's BA result is pulled, and its keyframe admission and artifacts
done, at the start of frame k+1, after frame k+1's depth chain and feature
detection are issued (`async_pipeline`), so host work overlaps the solve
on the device.

From `start_nerf_keyframes` keyframes on, keyframe batches train a
`NofRunner` (continual: `add_new_frames`), and its optimized poses are
synced back into the keyframes (`nerfed`, which pins them in the BA). The
reference trains in a child process, bounded by `sync_max_delay`
keyframes of lead; here either the tracker thread polls the batch chunk by
chunk, or (`async_host`) a worker thread owns each batch. The runner's
device work runs on its own CUDA stream in both forms. After `on_finish`,
`.mesh` holds the final mesh in real-world coordinates.

At `SPDLOG` >= 1 every frame leaves its artifacts (PNGs through
`utils/png.py`, the keyframe registry as JSON that PyYAML reads too,
`config.py::dump_yaml`);
`run_global_nerf` trains the offline refine from them and writes the
cleaned, real-world and textured meshes and the optimized poses.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time

import numpy as np
import torch

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.config import (default_nerf_config,
                                        default_track_config, dump_config,
                                        dump_yaml, load_config, load_yaml)
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.matcher.loftr import LoftrConfig, LoftrMatcher
from bundlesdf_tpu_torch.matcher.pairing import (map_matches_back,
                                                 process_image_pairs)
from bundlesdf_tpu_torch.mesh.texture import bake_texture
from bundlesdf_tpu_torch.nof.models import pose_array_matrices
from bundlesdf_tpu_torch.nof.runner import NofRunner, preprocess_frame_data
from bundlesdf_tpu_torch.scene.bounds import (compute_scene_bounds,
                                              compute_scene_bounds_frame,
                                              find_biggest_cluster,
                                              voxel_downsample)
from bundlesdf_tpu_torch.tracker.bundler import Bundler
from bundlesdf_tpu_torch.tracker.frame import Frame, FrameStatus
from bundlesdf_tpu_torch.utils.common import (GLCAM_IN_CVCAM,
                                              geodesic_distance_np,
                                              resize_nearest)
from bundlesdf_tpu_torch.utils import profiling
from bundlesdf_tpu_torch.utils.png import read_png, write_png


class BundleSdf:
    def __init__(self, cfg_track_dir=None, cfg_nerf_dir=None,
                 start_nerf_keyframes=5, matcher=None, use_gui=False,
                 cfg_track=None, cfg_nerf=None, device="cuda"):
        """@cfg_track_dir/@cfg_nerf_dir: YAML paths (reference schemas), or
        pass dicts directly via @cfg_track/@cfg_nerf. @device: where the
        frame pool, matching, RANSAC and BA run: the card unless "cpu"."""
        self.cfg_track = (cfg_track if cfg_track is not None
                          else load_config(cfg_track_dir,
                                           default_track_config()))
        self.cfg_nerf = (cfg_nerf if cfg_nerf is not None
                         else load_config(cfg_nerf_dir,
                                          default_nerf_config()))
        self.device = resolve_device(device)
        self.start_nerf_keyframes = start_nerf_keyframes
        self.debug_dir = self.cfg_track["debug_dir"]
        self.SPDLOG = int(self.cfg_track.get("SPDLOG", 1))
        os.makedirs(self.debug_dir, exist_ok=True)
        self.gui = None
        if use_gui:
            from bundlesdf_tpu_torch.gui import BundleSdfGui
            self.gui = BundleSdfGui(
                out_dir=os.path.join(self.debug_dir, "gui"))
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
                self.matcher = LoftrMatcher(
                    ckpt_path=ckpt, device=self.device, cfg=LoftrConfig(
                        amp=bool(self.cfg_track.get("loftr_amp", True))))
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
        self.mesh = None
        # tracker||NOF stall anatomy: wall seconds by phase, accumulated
        # across the run, each the seconds of its span (`utils/profiling`).
        # Keys: nerf_prep (span nof.prep: host batch prep, scene bounds +
        # ray store + runner init), nerf_dispatch (nof.dispatch:
        # start_training), nerf_poll (nof.poll: chunk feed from the tracker
        # thread), nerf_sync (nof.sync: blocking finish_training / worker
        # join), nerf_post (nof.post: pose sync-back + optional mesh
        # extract); nerf_worker_s (the worker thread's whole batches) and
        # nof_steps_total appear with the first batch. n_* are event
        # counts.
        self.pipeline_stats = {
            "nerf_prep_s": 0.0, "nerf_dispatch_s": 0.0, "nerf_poll_s": 0.0,
            "nerf_sync_s": 0.0, "nerf_post_s": 0.0,
            "n_batches": 0, "n_sync_blocks": 0}
        # threaded NOF host pipeline (the reference runs the NOF in a child
        # process, bundlesdf.py:64-260 + run:571-599): with async_host a
        # worker thread owns each batch (scene bounds, ray store, training,
        # drain) and the tracker only blocks on the sync_max_delay gate;
        # otherwise the tracker thread polls the batch chunk by chunk. None
        # resolves to threaded when sync_max_delay > 0.
        if self.cfg_nerf.get("async_host") is None:
            self._async_host = int(self.cfg_nerf.get("sync_max_delay", 0)) > 0
        else:
            self._async_host = bool(self.cfg_nerf.get("async_host"))
        self._nerf_thread: threading.Thread | None = None
        self._nerf_worker_err: Exception | None = None
        # per-frame wall stage timing (cfg_track['stage_timing']: true):
        # one {stage: seconds} dict per run() call. Pure perf_counter
        # spans, no device barriers, so the split is what the host loop
        # actually waits on.
        self._stage_timing = bool(self.cfg_track.get("stage_timing", False))
        self.stage_stats: list[dict] = []
        self._cur_stages: dict | None = None

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, name: str):
        """The span @name (`utils/profiling.py`), whose seconds also go
        into the current frame's stage dict unless stage_timing is off."""
        timed = self._stage_timing and self._cur_stages is not None
        sp = profiling.span(name)
        try:
            with sp:
                yield
        finally:
            if timed:
                self._cur_stages[name] = (self._cur_stages.get(name, 0.0)
                                          + sp.seconds)

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
            out_size = int(self.cfg_track["feature_corres"].get("resize",
                                                                400))
            cropsA, cropsB, tfs = process_image_pairs(
                frame_pairs, out_size,
                getattr(self.matcher, "device", self.device))
            raw = self.matcher.predict(cropsA, cropsB)
            raw = [map_matches_back(uv, tfA, tfB)
                   for uv, (tfA, tfB) in zip(raw, tfs)]

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
            if self.SPDLOG >= 1:
                np.savetxt(os.path.join(self.debug_dir, "cam_K.txt"), self.K)

        if self._stage_timing:
            self._cur_stages = {}
            self.stage_stats.append(self._cur_stages)
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
            if self.gui is not None:
                frame.gui_mask = mask
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
        """Post-BA per-frame tail: NOF keyframe feed + sync, artifact
        writes (ref bundlesdf.py:546-632)."""
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
            if ready and not self._nerf_busy():
                # idle NOF: consume everything accumulated as one batch. A
                # batch in flight does not block here: keyframes accumulate
                # and the next batch takes the whole list (the reference's
                # run_nerf child drains kf_to_nerf_list only between
                # train() calls, bundlesdf.py:96-129)
                self._run_nerf_batch()

        # tracker || NOF overlap with the reference's sync_max_delay
        # semantics (bundlesdf.py:571-599): keep tracking while the batch
        # trains, but block + sync once the tracker is sync_max_delay
        # keyframes ahead of the frames the NOF consumed (0 = strict sync,
        # config.yml:102)
        behind = len(self.bundler.keyframes) - self.nerf_num_frames
        max_ahead = int(self.cfg_nerf.get("sync_max_delay", 0))
        if self._async_host and self._nerf_thread is not None:
            done = not self._nerf_thread.is_alive()
        elif self.nerf is not None and self.nerf.training_in_flight:
            with profiling.span("nof.poll") as sp:
                done = self.nerf.poll_training()
            self.pipeline_stats["nerf_poll_s"] += sp.seconds
        else:
            done = None
        if done is not None and (done or behind >= max_ahead):
            if not done:
                self.pipeline_stats["n_sync_blocks"] += 1
            self._finish_nerf_batch()
            # reference consumer loop: the freed NOF immediately takes the
            # accumulated keyframes as its next batch
            if self.kf_to_nerf_list and self.cnt_nerf >= 0:
                self._run_nerf_batch()
        with self._stage("artifacts"):
            self.save_newframe_result(frame)
        if self.gui is not None:
            # GUI feed (ref bundlesdf.py:624-632)
            self.gui.set_nerf_num_frames(self.nerf_num_frames)
            if self.mesh is not None:
                self.gui.update_mesh(self.mesh)
            self.gui.update_frame(
                rgb=frame.color, mask=frame.gui_mask,
                ob_in_cam=np.linalg.inv(frame.pose_in_model),
                id_str=frame.id_str, K=self.K,
                n_keyframe=len(self.bundler.keyframes))

    # ------------------------------------------------------------------
    # NOF batch (ref run_nerf bundlesdf.py:64-260, continual branch)
    # ------------------------------------------------------------------
    def _run_nerf_batch(self):
        self.pipeline_stats["n_batches"] += 1
        batch = self.kf_to_nerf_list
        self.kf_to_nerf_list = []
        self.nerf_num_frames += len(batch)
        self.cnt_nerf += 1
        first = self.cnt_nerf == 0
        # pose snapshot on the tracker thread: the worker never reads
        # keyframe poses while BA writes them
        cam_in_obs = np.array([kf.pose_in_model for kf in
                               self.bundler.keyframes])
        if not self._async_host:
            self._nerf_batch_body(batch, cam_in_obs, first)
            return
        if self._nerf_thread is not None and self._nerf_thread.is_alive():
            raise RuntimeError("a NOF batch is already in flight")

        def work():
            try:
                t0 = time.perf_counter()
                self._nerf_batch_body(batch, cam_in_obs, first)
                # drive the batch chunk by chunk; the tracker's work
                # interleaves with it on the host and on the card
                while not self.nerf.poll_training(max_chunks=1):
                    time.sleep(0.002)
                self.nerf.finish_training()
                self._count_steps()
                self.pipeline_stats["nerf_worker_s"] = (
                    self.pipeline_stats.get("nerf_worker_s", 0.0)
                    + time.perf_counter() - t0)
            except Exception as e:  # raised on the tracker at the next join
                self._nerf_worker_err = e

        self._nerf_thread = threading.Thread(target=work, daemon=True,
                                             name="nof-worker")
        self._nerf_thread.start()

    def _count_steps(self):
        self.pipeline_stats["nof_steps_total"] = (
            self.pipeline_stats.get("nof_steps_total", 0)
            + int(self.nerf.global_step - self._nerf_gs0))

    def _nerf_batch_body(self, batch, cam_in_obs, first):
        """Batch prep + first chunk (ref run_nerf child body). Runs on the
        worker thread when async_host, else inline on the tracker."""
        with profiling.span("nof.prep") as sp:
            pcd_all = self._nerf_batch_prep(batch, cam_in_obs, first)
        self.pipeline_stats["nerf_prep_s"] += sp.seconds
        self._nerf_gs0 = self.nerf.global_step
        with profiling.span("nof.dispatch") as sp:
            self.nerf.start_training()
        self.pipeline_stats["nerf_dispatch_s"] += sp.seconds
        self.prev_pcd_real_scale = voxel_downsample(pcd_all, 0.01)

    def _nerf_batch_prep(self, batch, cam_in_obs, first):
        """Scene bounds, then a new runner or `add_new_frames` (ref
        run_nerf bundlesdf.py:96-210); returns the scene cloud in real
        scale."""
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
                build_octree_pts=pcd_norm, device=self.device,
                stream=None if self.nerf is None else self.nerf.stream)
        else:
            self.nerf.add_new_frames(rgbs_p, depths_p, masks_p, normals_p,
                                     poses_all, occ_masks=occ_masks,
                                     new_pcd=pcd_norm, reuse_weights=False)
        return pcd_all

    def _nerf_busy(self) -> bool:
        """True while a NOF batch is in flight OR has landed but its pose
        sync-back hasn't been applied on the tracker thread yet."""
        if self._nerf_thread is not None:
            return True
        return self.nerf is not None and self.nerf.training_in_flight

    def _finish_nerf_batch(self, final=False):
        """Block until the in-flight NOF batch completes, then sync the
        optimized poses back into the keyframes."""
        if self._nerf_thread is None and not (
                self.nerf is not None and self.nerf.training_in_flight):
            return
        with profiling.span("nof.sync") as sp:
            if self._nerf_thread is not None:
                self._nerf_thread.join()
                self._nerf_thread = None
                if self._nerf_worker_err is not None:
                    err, self._nerf_worker_err = self._nerf_worker_err, None
                    raise err
            else:
                self.nerf.finish_training()
                self._count_steps()
        self.pipeline_stats["nerf_sync_s"] += sp.seconds
        with profiling.span("nof.post") as sp:
            self._sync_poses_from_nerf(final=final)
        self.pipeline_stats["nerf_post_s"] += sp.seconds

    def _sync_poses_from_nerf(self, final=False):
        """Overwrite keyframe poses with NOF-optimized poses and mark them
        nerfed (ref bundlesdf.py:587-617)."""
        if self.nerf is None:
            return
        optimized, offset = self.nerf.get_optimized_poses_in_real_world()
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

        # the per-batch mesh exists to feed the GUI (ref bundlesdf.py:234-241);
        # runs without one skip the dense SDF query + marching unless
        # mesh_every_batch asks. The final batch always extracts.
        if final or self.gui is not None \
                or bool(self.cfg_nerf.get("mesh_every_batch", False)):
            mesh = self.nerf.extract_mesh()
            if mesh is not None:
                self.mesh = self.nerf.mesh_to_real_world(mesh,
                                                         pose_offset=offset)

    # ------------------------------------------------------------------
    # outputs (ref saveNewframeResult Bundler.cpp:959-1111)
    # ------------------------------------------------------------------
    def save_newframe_result(self, frame: Frame):
        if self.SPDLOG < 1:
            return
        dd = self.debug_dir
        for sub in ("ob_in_cam", "color", "color_segmented", "depth",
                    "depth_filtered", "depth_vis", "normal", "mask"):
            os.makedirs(os.path.join(dd, sub), exist_ok=True)
        ob_in_cam = np.linalg.inv(frame.pose_in_model)
        np.savetxt(os.path.join(dd, "ob_in_cam", f"{frame.id_str}.txt"),
                   ob_in_cam)
        # frame status record (ref Bundler.cpp:1087-1095 frame.txt)
        kf_dir = os.path.join(dd, frame.id_str)
        os.makedirs(kf_dir, exist_ok=True)
        with open(os.path.join(kf_dir, "frame.txt"), "w") as f:
            f.write(f"status: {frame.status.name}\n")
            if frame.ref_frame_id >= 0:
                f.write(f"ref_frame_id: {frame.ref_frame_id}\n")
        self._save_images(frame)
        # keyframe registry for global refine (ref keyframes.yml), as JSON
        # that PyYAML reads back unchanged
        reg = {kf.id_str: {"cam_in_ob": kf.pose_in_model.reshape(-1).tolist(),
                           "nerfed": bool(kf.nerfed)}
               for kf in self.bundler.keyframes}
        dump_yaml(reg, os.path.join(kf_dir, "keyframes.yml"))

    def _save_images(self, frame: Frame):
        """The frame's PNG artifacts, pixel for pixel those the JAX package
        writes with cv2 (RGB images stored as RGB)."""
        dd = self.debug_dir
        write_png(os.path.join(dd, "color", f"{frame.id_str}.png"),
                  frame.color)
        # mask-applied color (ref _color after invalidatePixelsByMask,
        # Bundler.cpp:1034-1039 color_segmented/)
        seg = frame.color.copy()
        seg[frame.fg_mask == 0] = 0
        write_png(os.path.join(dd, "color_segmented", f"{frame.id_str}.png"),
                  seg)
        write_png(os.path.join(dd, "depth", f"{frame.id_str}.png"),
                  (frame.depth_raw * 1000).astype(np.uint16))
        write_png(os.path.join(dd, "depth_filtered", f"{frame.id_str}.png"),
                  (frame.depth * 1000).astype(np.uint16))
        write_png(os.path.join(dd, "mask", f"{frame.id_str}.png"),
                  (frame.fg_mask > 0).astype(np.uint8) * 255)
        # inverse-depth visualization (ref Bundler.cpp:1044-1055)
        with np.errstate(divide="ignore"):
            dv = np.where(frame.depth >= 0.1, 1.0 / frame.depth / 10 * 255, 0)
        write_png(os.path.join(dd, "depth_vis", f"{frame.id_str}.png"),
                  np.clip(dv, 0, 255).astype(np.uint8))
        # normal map packed to [0,255] rgb (ref Bundler.cpp:1016-1032)
        n = frame.normal_map
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where((frame.depth[..., None] >= 0.1) & (norm > 1e-8),
                     n / np.maximum(norm, 1e-8), 0.0)
        write_png(os.path.join(dd, "normal", f"{frame.id_str}.png"),
                  ((n + 1) / 2 * 255).astype(np.uint8))

    # ------------------------------------------------------------------
    def on_finish(self):
        """Final pipeline + NOF flush (ref on_finish bundlesdf.py:324-338):
        train the keyframes still waiting, sync, and extract the mesh."""
        self.flush_pipeline()
        if self.kf_to_nerf_list and (self.cnt_nerf >= 0 or
                                     len(self.kf_to_nerf_list) >=
                                     self.start_nerf_keyframes):
            self._finish_nerf_batch()
            self._run_nerf_batch()
        self._finish_nerf_batch(final=True)
        if self.nerf is not None and self.mesh is None:
            # the last batch completed before on_finish (headless runs skip
            # the per-batch extract): produce the final mesh now
            _, offset = self.nerf.get_optimized_poses_in_real_world()
            mesh = self.nerf.extract_mesh()
            if mesh is not None:
                self.mesh = self.nerf.mesh_to_real_world(mesh,
                                                         pose_offset=offset)

    # ------------------------------------------------------------------
    # offline global refine (ref run_global_nerf bundlesdf.py:636-766)
    # ------------------------------------------------------------------
    def run_global_nerf(self, reader=None, get_texture=False, tex_res=1024,
                        out_dir=None):
        """Train a NOF from scratch on the keyframes the online run saved
        (`SPDLOG` >= 1: `cam_K.txt`, the latest `keyframes.yml`, the
        `color/`, `depth_filtered/` and `mask/` PNGs), on its own CUDA
        stream; then extract, clean and (@get_texture) texture the mesh.
        Writes `config.yml`, `mesh_cleaned.obj`, `mesh_real_world.obj` and
        `optimized_poses.txt` into @out_dir (default
        `<debug_dir>/nerf_with_bundletrack_online`) and
        `<debug_dir>/textured_mesh.obj`. Returns the real-world mesh;
        `refine_stats` holds the step count and the stage seconds.
        @reader is accepted and unused, as in the JAX package: the images
        come from the artifacts."""
        dd = self.debug_dir
        self.K = np.loadtxt(os.path.join(dd, "cam_K.txt")).reshape(3, 3)
        # latest frame stamp with a keyframe registry
        stamps = sorted([d for d in os.listdir(dd)
                         if os.path.isdir(os.path.join(dd, d))
                         and os.path.exists(os.path.join(dd, d,
                                                         "keyframes.yml"))])
        if not stamps:
            raise FileNotFoundError("no keyframes.yml found; run online first")
        reg = load_yaml(os.path.join(dd, stamps[-1], "keyframes.yml"))

        ids = sorted(reg.keys())
        n_train = int(self.cfg_nerf.get("n_train_image", 300))
        if len(ids) > n_train:
            sel = np.linspace(0, len(ids) - 1, n_train).astype(int)
            ids = [ids[i] for i in sel]

        t_read = time.perf_counter()
        rgbs, depths, masks, poses = [], [], [], []
        for id_str in ids:
            rgbs.append(read_png(os.path.join(dd, "color", f"{id_str}.png")))
            depths.append(read_png(os.path.join(
                dd, "depth_filtered", f"{id_str}.png")).astype(np.float32)
                / 1000.0)
            m = read_png(os.path.join(dd, "mask", f"{id_str}.png"))
            masks.append((m > 0).astype(np.uint8))
            poses.append(np.asarray(reg[id_str]["cam_in_ob"],
                                    np.float64).reshape(4, 4))
        rgbs = np.array(rgbs)
        depths = np.array(depths)
        masks = np.array(masks)
        cam_in_obs = np.array(poses)
        glcam_in_obs = cam_in_obs @ GLCAM_IN_CVCAM

        cfg = copy.deepcopy(self.cfg_nerf)
        if self.sc_factor is None:
            sc_factor, translation, pcd_real, pcd_norm = compute_scene_bounds(
                rgbs, depths, masks, glcam_in_obs, self.K, use_mask=True,
                eps=cfg["dbscan_eps"],
                min_samples=cfg["dbscan_eps_min_samples"])
            self.sc_factor, self.translation = float(sc_factor), translation
        else:
            _, _, pcd_real, pcd_norm = compute_scene_bounds(
                rgbs, depths, masks, glcam_in_obs, self.K, use_mask=True,
                translation_cvcam=np.asarray(self.translation),
                sc_factor=self.sc_factor, eps=cfg["dbscan_eps"],
                min_samples=cfg["dbscan_eps_min_samples"])
        cfg["sc_factor"] = self.sc_factor
        cfg["translation"] = np.asarray(self.translation)

        rgbs_p, depths_p, masks_p, normals_p, poses_p = preprocess_frame_data(
            rgbs, depths, masks, None, glcam_in_obs.copy(), self.sc_factor,
            np.asarray(self.translation))
        self.nerf = NofRunner(cfg, rgbs_p, depths_p, masks_p, normals_p,
                              poses_p, self.K, build_octree_pts=pcd_norm,
                              device=self.device)
        t_train = time.perf_counter()
        # train()'s N_iters = n_step + 1 steps; the first chunk (the
        # kernel's build, the allocator's first blocks) is timed apart
        # from the refine rate, as the reference times its compile apart
        n_total = int(cfg["n_step"]) + 1
        n_first = min(self.nerf.scan_chunk, n_total)
        self.nerf.train(n_steps=n_first)
        t0 = time.perf_counter()
        self.nerf.train(n_steps=n_total - n_first)   # ends with a host pull
        dt = time.perf_counter() - t0
        n_rest = n_total - n_first
        logging.info(
            f"global refine: {n_rest} steps in {dt:.1f}s = "
            f"{n_rest / max(dt, 1e-9):.2f} steps/s "
            f"({dt / max(n_rest, 1) * 1e3:.1f} ms/step, first chunk of "
            f"{n_first} {t0 - t_train:.1f}s, {cfg['num_levels']} levels, "
            f"T=2^{cfg['log2_hashmap_size']})")

        t_mesh = time.perf_counter()
        mesh = self.nerf.extract_mesh(voxel_size=cfg["mesh_resolution"])
        out_dir = out_dir or os.path.join(dd, "nerf_with_bundletrack_online")
        os.makedirs(out_dir, exist_ok=True)
        # config-as-artifact with learned normalization (ref
        # bundlesdf.py:731-737): postprocess_mesh reloads sc/translation
        dump_config({**cfg, "translation": np.asarray(self.translation)
                     .tolist(), "sc_factor": float(self.sc_factor)},
                    os.path.join(out_dir, "config.yml"))
        t_tex = t_tex_end = None
        if mesh is not None:
            mesh.merge_vertices()
            mesh.keep_biggest_component()
            mesh.export(os.path.join(out_dir, "mesh_cleaned.obj"))
            _, offset = self.nerf.get_optimized_poses_in_real_world()
            if get_texture:
                # bake per-frame colors in normalized space with the NOF's
                # corrected poses (ref mesh_texture_from_train_images
                # nerf_runner.py:1468-1542, called bundlesdf.py:763)
                t_tex = time.perf_counter()
                with self.nerf._on_stream(), torch.no_grad():
                    corr = pose_array_matrices(
                        self.nerf.field.pose_array,
                        torch.arange(len(self.nerf.poses),
                                     device=self.nerf.device),
                        self.nerf.spec.max_trans,
                        self.nerf.spec.max_rot_deg).cpu().numpy()
                tex_mesh = bake_texture(
                    mesh, rgbs, masks, self.nerf.poses, self.K,
                    pose_corrections=corr, tex_res=tex_res)
                self.nerf.mesh_to_real_world(tex_mesh, pose_offset=offset)
                tex_mesh.export(os.path.join(dd, "textured_mesh.obj"))
                t_tex_end = time.perf_counter()
            world = self.nerf.mesh_to_real_world(mesh.copy(),
                                                 pose_offset=offset)
            world.export(os.path.join(out_dir, "mesh_real_world.obj"))
            self.mesh = world
        optimized, _ = self.nerf.get_optimized_poses_in_real_world()
        np.savetxt(os.path.join(out_dir, "optimized_poses.txt"),
                   optimized.reshape(-1, 4))
        t_end = time.perf_counter()
        tex_s = 0.0 if t_tex is None else t_tex_end - t_tex
        self.refine_stats = {
            "keyframes": len(ids), "steps": n_total, "timed_steps": n_rest,
            "train_s": dt, "steps_per_s": n_rest / max(dt, 1e-9),
            "first_chunk_s": t0 - t_train,
            "read_prep_s": t_train - t_read,
            "mesh_s": t_end - t_mesh - tex_s, "texture_s": tex_s}
        return self.mesh
