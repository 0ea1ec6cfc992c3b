"""Bundler: keyframe pool, correspondence store, per-frame tracking pipeline.

Port of `bundlesdf_tpu/tracker/bundler.py` (the reference C++ `Bundler`,
`Bundler.cpp`, plus the live-path pieces of `SiftManager`/`GluNet`,
`FeatureManager.cpp`). The pipeline control flow (FAIL cascade, ref
reselection, keyframe admission, BA window selection) is the JAX
package's host logic as it is; the per-pair geometry (correspondence
lifting/gating, RANSAC, covisibility, bundle adjustment) runs on the
device in `tracker/pool.py` and `tracker/ba.py`, and each call's results
come back in one `HostPull`.

The bundle adjustment's pair, correspondence and keyframe counts are
padded to a few buckets with masked-out rows, as the JAX package pads
them to compile buckets, so that on CUDA each padded shape is one CUDA
graph, captured once and replayed (`tracker/ba_graph.py`).
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.tracker.ba import BAConfig
from bundlesdf_tpu_torch.tracker.ba_graph import (C_MIN, KF_MIN, BAGraphs,
                                                  pow2_at_least)
from bundlesdf_tpu_torch.tracker.frame import Frame, FrameStatus
from bundlesdf_tpu_torch.tracker.pool import (FramePool, covis_core,
                                              lift_ransac_slots,
                                              orb_lift_ransac_slots)
from bundlesdf_tpu_torch.utils.se3 import (kabsch_np,
                                           rot_geodesic_ignore_cam_z_np)
from bundlesdf_tpu_torch.utils.png import write_png
from bundlesdf_tpu_torch.utils.profiling import span
from bundlesdf_tpu_torch.utils.transfer import HostPull
from bundlesdf_tpu_torch.utils.viz import draw_line


def corres_arrays(blocks) -> dict:
    """The BA's sparse correspondences from @blocks, [(j, i, match)] with
    j frame A's and i frame B's window index (the EntryJ convention), in
    order, padded to C = a power of two >= `C_MIN` by rows with index 0,
    points 0 and `corr_valid` 0."""
    n = np.array([len(m["conf"]) for _, _, m in blocks], np.int64)
    C = int(n.sum())
    Cp = pow2_at_least(C, C_MIN)
    out = dict(corr_i=np.zeros(Cp, np.int64), corr_j=np.zeros(Cp, np.int64),
               corr_pi=np.zeros((Cp, 3), np.float32),
               corr_pj=np.zeros((Cp, 3), np.float32),
               corr_valid=np.zeros(Cp, np.float32))
    out["corr_j"][:C] = np.repeat([j for j, _, _ in blocks], n)
    out["corr_i"][:C] = np.repeat([i for _, i, _ in blocks], n)
    out["corr_pj"][:C] = np.concatenate([m["pA_cam"] for _, _, m in blocks])
    out["corr_pi"][:C] = np.concatenate([m["pB_cam"] for _, _, m in blocks])
    out["corr_valid"][:C] = 1.0
    return out


class Bundler:
    """@cfg: tracker config dict (schema of config_ho3d.yml).
    @matcher: object with predict(imgA_batch, imgB_batch) -> list of (N,5)
    [uA,vA,uB,vB,conf] arrays (the LoFTR-wrapper contract,
    loftr_wrapper.py:28-82)."""

    # matches kept per pair (the most confident) before RANSAC
    MATCH_CAP = 1024

    def __init__(self, cfg, matcher=None, device="cuda"):
        self.cfg = cfg
        self.matcher = matcher
        self.device = resolve_device(device)
        self.frames: dict[int, Frame] = {}
        self.keyframes: list[Frame] = []
        self.first_frame: Frame | None = None
        self.new_frame: Frame | None = None
        self.local_frames: list[Frame] = []
        # (idA,idB) -> dict of match arrays; idA > idB always
        self.matches: dict[tuple[int, int], dict] = {}
        # frame_id -> {(u,v) -> map point track {frame_id: (u,v)}}
        self._map_points: dict[int, dict] = {}
        # RANSAC RNG: a host counter seeding each call's device generator
        self._seed_ctr = 0
        # device-resident frame-map pool; created at first frame (needs H,W)
        self.pool: FramePool | None = None
        # the bundle adjustment, replayed as one CUDA graph per padded shape
        self._ba = BAGraphs()

    # ------------------------------------------------------------------
    # frame-map pool
    # ------------------------------------------------------------------
    def ensure_pool(self, H: int, W: int) -> FramePool:
        if self.pool is None:
            self.pool = FramePool(H, W, device=self.device)
        return self.pool

    def _t(self, a, dtype=None):
        """Host array -> tensor on the bundler's device (a host->device
        copy, which waits for the stream's queued work)."""
        with span("pull.track.upload"):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

    def _slot(self, frame: Frame) -> int:
        """Pool slot of a frame; frames constructed standalone (tests /
        legacy callers) are adopted into the pool on first touch."""
        if frame.pooled:
            return frame.slot
        pool = self.ensure_pool(frame.H, frame.W)
        valid = (frame.depth_dev > 0.1) & (
            torch.as_tensor(frame.fg_mask, device=frame.depth_dev.device) > 0)
        frame.slot = pool.insert_maps(frame.id, frame.depth_dev,
                                      frame.xyz_dev, frame.normal_dev, valid)
        frame.pool = pool
        frame.depth_dev = frame.xyz_dev = frame.normal_dev = None
        if float(self.cfg["bundle"].get("w_dense_color", 0) or 0) > 0:
            pool.set_grey(frame.id, frame.color.astype(np.float32)
                          .mean(axis=-1) / 255.0)
        return frame.slot

    # ------------------------------------------------------------------
    # covisibility (ref Frame.h:122-165 via the pool kernel)
    # ------------------------------------------------------------------
    def covisibility(self, fA: Frame, fB: Frame) -> float:
        return self.covisibility_many(fA, [fB])[0]

    def covisibility_many(self, fA: Frame, fBs: list) -> np.ndarray:
        """Covisibility of fA against many frames in ONE device dispatch."""
        return self.covisibility_pairs([(fA, fB) for fB in fBs])

    def covisibility_pairs(self, pairs: list) -> np.ndarray:
        """Covisibility for arbitrary (fA, fB) items in one device call
        (sources may differ — this batches every covisibility call site of
        a frame's pipeline)."""
        if not pairs:
            return np.zeros((0,), np.float32)
        P = len(pairs)
        slots = np.zeros(P, np.int64)
        Ts = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        for i, (fA, fB) in enumerate(pairs):
            slots[i] = self._slot(fA)
            Ts[i] = (np.linalg.inv(fB.pose_in_model)
                     @ fA.pose_in_model).astype(np.float32)
        pool = self.pool
        thres = float(np.cos(np.deg2rad(self.cfg["visible_angle"])))
        out = covis_core(pool.xyzs_h, pool.nrms_h, pool.valids_h,
                         self._t(slots), self._t(Ts), thres)
        return HostPull({"c": out}, "track.covis").get()["c"]

    # ------------------------------------------------------------------
    # correspondence construction + RANSAC, fused (ref rawMatchesToCorres
    # FeatureManager.cpp:2720-2769 + runRansacMultiPairGPU :1587-1713 +
    # cuda_ransac.cu): lifting, 3D gating, model-frame transform and
    # multi-pair RANSAC run on the device over pool slots, all pairs of a
    # call at once, with one host pull.
    # ------------------------------------------------------------------
    def match_pairs(self, frame_pairs, raw_uvs, viz=True):
        """@frame_pairs: [(fA, fB)]; @raw_uvs: per-pair (N,>=4) arrays of
        [uA,vA,uB,vB(,conf)] full-res pixel matches (or None). Populates
        self.matches with post-RANSAC inlier matches; pairs below
        min_match_after_ransac are cleared (None)."""
        cfg = self.cfg["ransac"]
        M = self.MATCH_CAP
        live = []
        for (fA, fB), uv in zip(frame_pairs, raw_uvs):
            if uv is None or len(uv) == 0:
                self.matches[(fA.id, fB.id)] = None
                continue
            live.append((fA, fB, np.asarray(uv)))
        if not live:
            return

        P = len(live)
        M = min(M, max(len(uv) for *_, uv in live))
        slots_a = np.zeros(P, np.int64)
        slots_b = np.zeros(P, np.int64)
        uvA = np.zeros((P, M, 2), np.int32)
        uvB = np.zeros((P, M, 2), np.int32)
        conf = np.zeros((P, M), np.float32)
        valid = np.zeros((P, M), bool)
        TA = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        TB = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        caps = np.full((P, 2), np.inf, np.float32)
        hostm = []
        for i, (fA, fB, uv) in enumerate(live):
            uA = np.round(uv[:, 0]).astype(np.int32)
            vA = np.round(uv[:, 1]).astype(np.int32)
            uB = np.round(uv[:, 2]).astype(np.int32)
            vB = np.round(uv[:, 3]).astype(np.int32)
            c = (uv[:, 4] if uv.shape[1] > 4
                 else np.ones(len(uv))).astype(np.float32)
            inb = ((uA >= 0) & (uA < fA.W) & (vA >= 0) & (vA < fA.H)
                   & (uB >= 0) & (uB < fB.W) & (vB >= 0) & (vB < fB.H))
            if len(uv) > M:  # keep the most confident
                order = np.argsort(-c)[:M]
                uA, vA, uB, vB = uA[order], vA[order], uB[order], vB[order]
                c, inb = c[order], inb[order]
            n = len(uA)
            uvA[i, :n] = np.stack([np.clip(uA, 0, fA.W - 1),
                                   np.clip(vA, 0, fA.H - 1)], -1)
            uvB[i, :n] = np.stack([np.clip(uB, 0, fB.W - 1),
                                   np.clip(vB, 0, fB.H - 1)], -1)
            conf[i, :n] = c
            valid[i, :n] = inb
            slots_a[i] = self._slot(fA)
            slots_b[i] = self._slot(fB)
            TA[i] = fA.pose_in_model.astype(np.float32)
            TB[i] = fB.pose_in_model.astype(np.float32)
            if fA.ref_frame_id == fB.id and fA.id == fB.id + 1:
                caps[i] = (cfg["max_trans_neighbor"],
                           np.deg2rad(cfg["max_rot_deg_neighbor"]))
            elif fA.ref_frame_id != fB.id:
                caps[i] = (cfg["max_trans_no_neighbor"],
                           np.deg2rad(cfg["max_rot_no_neighbor"]))
            hostm.append((np.stack([uA, vA], -1), np.stack([uB, vB], -1), c))

        self._seed_ctr += 1  # seeds this call's RANSAC draw
        pool = self.pool
        t = self._t
        res = lift_ransac_slots(
            pool.xyzs, pool.nrms, t(slots_a), t(slots_b), t(uvA), t(uvB),
            t(valid), t(conf), t(TA), t(TB), t(caps[:, 0]), t(caps[:, 1]),
            self._seed_ctr, cfg["inlier_dist"],
            float(np.cos(np.deg2rad(cfg["inlier_normal_angle"]))),
            n_trials=int(cfg["max_iter"]))
        res = HostPull(res, "track.ransac").get()  # one wait for all pairs

        for i, (fA, fB, _) in enumerate(live):
            uvA_h, uvB_h, c = hostm[i]
            n = len(c)
            ok = res["ok"][i, :n]
            key = (fA.id, fB.id)
            # pre-RANSAC (3D-gated) matches, for viz parity with the
            # reference's before_ransac dumps
            pre = {"uvA": uvA_h[ok], "uvB": uvB_h[ok],
                   "pA_cam": res["pA_cam"][i, :n][ok],
                   "pB_cam": res["pB_cam"][i, :n][ok],
                   "nA_cam": res["nA_cam"][i, :n][ok],
                   "nB_cam": res["nB_cam"][i, :n][ok],
                   "conf": c[ok]}
            self.matches[key] = pre
            if viz:
                self.viz_corres_between(fA, fB, "before_ransac")
            inlier = res["inlier_mask"][i, :n]
            if inlier.sum() < cfg["min_match_after_ransac"]:
                logging.info(f"ransac {fA.id_str}-{fB.id_str}: "
                             f"{int(inlier.sum())} inliers, cleared")
                self.matches[key] = None
                continue
            keep = inlier[ok]
            self.matches[key] = {k2: v[keep] for k2, v in pre.items()}
            if viz:
                self.viz_corres_between(fA, fB, "after_ransac")

    def match_pairs_fused(self, frame_pairs, matcher):
        """The whole find_corres device path with one host pull: batched
        ORB matching + top-M selection + lifting + 3D gating + multi-pair
        RANSAC (`orb_lift_ransac_slots`). Semantics match match_frames ->
        match_pairs. Returns per-pair pre-RANSAC raw match counts (the
        min_match_with_ref gate input)."""
        cfg = self.cfg["ransac"]
        M = self.MATCH_CAP
        feats = [(matcher._frame_feats(fA), matcher._frame_feats(fB))
                 for fA, fB in frame_pairs]
        live = []
        n_raw_out = [0] * len(frame_pairs)
        for i, ((_, dA, *_), (_, dB, *_)) in enumerate(feats):
            if dA is None or dB is None:
                fA, fB = frame_pairs[i]
                self.matches[(fA.id, fB.id)] = None
            else:
                live.append(i)
        if not live:
            return n_raw_out

        P = len(live)
        F = matcher.FEAT_CAP
        nbits = feats[live[0]][0][2].shape[1]
        colA, colB, uvcA, uvcB = [], [], [], []
        nA = np.zeros(P, np.int64)
        nB = np.zeros(P, np.int64)
        slots_a = np.zeros(P, np.int64)
        slots_b = np.zeros(P, np.int64)
        TA = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        TB = TA.copy()
        caps = np.full((P, 2), np.inf, np.float32)
        for k, i in enumerate(live):
            fA, fB = frame_pairs[i]
            (uvA_h, _, bA, uA_d), (uvB_h, _, bB, uB_d) = feats[i]
            colA.append(bA)
            colB.append(bB)
            uvcA.append(uA_d)
            uvcB.append(uB_d)
            nA[k], nB[k] = len(uvA_h), len(uvB_h)
            slots_a[k] = self._slot(fA)
            slots_b[k] = self._slot(fB)
            TA[k] = fA.pose_in_model.astype(np.float32)
            TB[k] = fB.pose_in_model.astype(np.float32)
            if fA.ref_frame_id == fB.id and fA.id == fB.id + 1:
                caps[k] = (cfg["max_trans_neighbor"],
                           np.deg2rad(cfg["max_rot_deg_neighbor"]))
            elif fA.ref_frame_id != fB.id:
                caps[k] = (cfg["max_trans_no_neighbor"],
                           np.deg2rad(cfg["max_rot_no_neighbor"]))

        self._seed_ctr += 1  # seeds this call's RANSAC draw
        pool = self.pool
        t = self._t
        # compact pull: RANSAC inliers only (top-256 by conf, int16 uv). The
        # cap is part of the result (matches beyond the 256 most confident
        # inliers are dropped, as in the JAX package). The full tables are
        # pulled for SPDLOG>=3 because the before_ransac viz needs them
        # (ref vizCorresBetween).
        k_pull = 0 if int(self.cfg.get("SPDLOG", 1)) >= 3 else 256
        # the deferred non-neighbor covisibility gate rides the same
        # program (see get_feature_match_pairs)
        pending = getattr(self, "_covis_gate_pending", set())
        gate_args = {}
        if pending:
            gate_args = dict(
                xyzs_h=pool.xyzs_h, nrms_h=pool.nrms_h,
                valids_h=pool.valids_h,
                covis_thres_cos=float(
                    np.cos(np.deg2rad(self.cfg["visible_angle"]))))
        # ref-match fusion: device procrustes + window-selection
        # covisibility ride this dispatch (set by the orchestrator for the
        # (new_frame, ref) call when the BA window selection will need
        # covisibility scores — saves one dispatch+pull per steady frame)
        sel_ctx = getattr(self, "_sel_ctx", None)
        self._sel_ctx = None
        self._ref_match_result = None
        sel_args = {}
        if sel_ctx is not None and len(live) == 1:
            kfs = sel_ctx["kfs"]
            extras = sel_ctx["extra_pairs"]
            KF = max(len(kfs), 1)
            kf_slots = np.zeros(KF, np.int64)
            kf_poses = np.tile(np.eye(4, dtype=np.float32), (KF, 1, 1))
            for k2, kf in enumerate(kfs):
                kf_slots[k2] = self._slot(kf)
                kf_poses[k2] = kf.pose_in_model.astype(np.float32)
            fA0, fB0 = frame_pairs[live[0]]
            gates = np.array([
                self.cfg["feature_corres"]["min_match_with_ref"],
                cfg["min_match_after_ransac"],
                k_pull if k_pull else M,
                1.0 if fA0.id - fB0.id == 1 else 0.0], np.float32)
            sel_args = dict(
                sel_kf_slots=t(kf_slots), sel_kf_poses=t(kf_poses),
                proc_gates=t(gates),
                xyzs_h=pool.xyzs_h, nrms_h=pool.nrms_h,
                valids_h=pool.valids_h,
                covis_thres_cos=float(
                    np.cos(np.deg2rad(self.cfg["visible_angle"]))))
            if extras:
                E = len(extras)
                ex_slots = np.zeros(E, np.int64)
                ex_Ts = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
                for k2, (exA, exB) in enumerate(extras):
                    ex_slots[k2] = self._slot(exA)
                    ex_Ts[k2] = (np.linalg.inv(exB.pose_in_model)
                                 @ exA.pose_in_model).astype(np.float32)
                sel_args.update(sel_extra_slots=t(ex_slots),
                                sel_extra_Ts=t(ex_Ts))
            gate_args = {**gate_args, **sel_args}
        res = HostPull(orb_lift_ransac_slots(
            pool.xyzs, pool.nrms, *(torch.stack(c).to(self.device) for c in
                                    (colA, colB, uvcA, uvcB)), t(nA), t(nB),
            t(slots_a), t(slots_b), t(TA), t(TB), t(caps[:, 0]),
            t(caps[:, 1]), self._seed_ctr, cfg["inlier_dist"],
            float(np.cos(np.deg2rad(cfg["inlier_normal_angle"]))),
            ratio=float(matcher.ratio), nbits=int(nbits),
            ratio_loose=float(getattr(matcher, "ratio_loose", 0.0)),
            min_strict=int(getattr(matcher, "min_strict", 0)),
            m_cap=min(M, F), n_trials=int(cfg["max_iter"]),
            k_pull=k_pull, **gate_args), "track.orb_ransac").get()

        if sel_args:
            fA0, fB0 = frame_pairs[live[0]]
            covis_cache = {(fA0.id, kf.id): float(res["covis_kf"][k2])
                           for k2, kf in enumerate(sel_ctx["kfs"])}
            for k2, (exA, exB) in enumerate(sel_ctx["extra_pairs"]):
                covis_cache[(exA.id, exB.id)] = float(res["covis_extra"][k2])
            self._ref_match_result = {
                "pair": (fA0.id, fB0.id),
                "offset": np.asarray(res["proc_offset"], np.float64),
                "use": bool(res["proc_use"]),
                "err": float(res["proc_err"]),
                "covis": covis_cache,
            }

        min_vis = self.cfg["bundle"]["non_neighbor_min_visible"]
        fields = ("uvA", "uvB", "pA_cam", "pB_cam", "nA_cam", "nB_cam",
                  "conf")
        # compact pull omits match-table normals (no consumer; 40% bytes)
        fields_c = ("uvA", "uvB", "pA_cam", "pB_cam", "conf")
        for k, i in enumerate(live):
            fA, fB = frame_pairs[i]
            n_raw_out[i] = int(res["n_raw"][k])
            key = (fA.id, fB.id)
            if key in pending:
                pending.discard(key)
                if float(res["covis"][k]) < min_vis:
                    self.matches[key] = None
                    continue
            if k_pull:
                n_in = int(res["n_in"][k])
                if n_in < cfg["min_match_after_ransac"]:
                    logging.info(f"ransac {fA.id_str}-{fB.id_str}: "
                                 f"{n_in} inliers, cleared")
                    self.matches[key] = None
                    continue
                keep = res["conf"][k] > 0
                self.matches[key] = {
                    f: (res[f][k][keep].astype(np.int32)
                        if f in ("uvA", "uvB") else res[f][k][keep])
                    for f in fields_c}
                continue
            ok = res["ok"][k]
            pre = {f: res[f][k][ok] for f in fields}
            self.matches[key] = pre
            self.viz_corres_between(fA, fB, "before_ransac")
            inlier = res["inlier_mask"][k]
            if inlier.sum() < cfg["min_match_after_ransac"]:
                logging.info(f"ransac {fA.id_str}-{fB.id_str}: "
                             f"{int(inlier.sum())} inliers, cleared")
                self.matches[key] = None
                continue
            keep = inlier[ok]
            self.matches[key] = {k2: v[keep] for k2, v in pre.items()}
            self.viz_corres_between(fA, fB, "after_ransac")
        return n_raw_out

    def n_matches(self, fA: Frame, fB: Frame) -> int:
        m = self.matches.get((fA.id, fB.id))
        return 0 if m is None else len(m["conf"])

    # ------------------------------------------------------------------
    # map points: persistent multi-frame feature tracks
    # (ref updateFramePairMapPoints FeatureManager.cpp:854-891 and
    # findCorresByMapPoints :939-970; enabled by feature_corres.map_points)
    # ------------------------------------------------------------------
    def update_map_points(self, fA: Frame, fB: Frame):
        """Merge the (post-RANSAC) inlier matches of a pair into map-point
        tracks. A map point is a dict {frame_id: (u,v)} shared via each
        frame's `map_points` registry."""
        m = self.matches.get((fA.id, fB.id))
        if m is None or len(m["conf"]) == 0:
            return
        regA = self._map_points.setdefault(fA.id, {})
        regB = self._map_points.setdefault(fB.id, {})
        for (uA, vA), (uB, vB) in zip(map(tuple, m["uvA"]),
                                      map(tuple, m["uvB"])):
            if (uA, vA) in regA and (uB, vB) in regB:
                continue
            mpt = regB.get((uB, vB))
            if mpt is None:
                mpt = {fB.id: (uB, vB)}
                regB[(uB, vB)] = mpt
            mpt[fA.id] = (uA, vA)
            regA[(uA, vA)] = mpt

    def propagate_matches(self, fA: Frame, fB: Frame):
        """uv matches implied by shared map points (marked propagated in
        the reference; used to seed/augment pair matching). Returns
        (P,5) [uA,vA,uB,vB,conf] or empty."""
        regA = self._map_points.get(fA.id, {})
        rows = []
        for (uA, vA), mpt in regA.items():
            if fB.id in mpt:
                uB, vB = mpt[fB.id]
                rows.append([uA, vA, uB, vB, 1.0])
        return np.asarray(rows, np.float32).reshape(-1, 5)

    # ------------------------------------------------------------------
    # pose from correspondences (ref procrustesByCorrespondence
    # FeatureManager.cpp:1050-1129). Host numpy: <=1024 points. The steady
    # ref-match path gets the same solve from the device instead
    # (`_procrustes_and_covis`).
    # ------------------------------------------------------------------
    def procrustes(self, fA: Frame, fB: Frame):
        m = self.matches.get((fA.id, fB.id))
        if m is None or len(m["conf"]) < 5:
            return np.eye(4)
        TA = fA.pose_in_model
        TB = fB.pose_in_model
        src = m["pA_cam"] @ TA[:3, :3].T + TA[:3, 3]
        dst = m["pB_cam"] @ TB[:3, :3].T + TB[:3, 3]
        # degeneracy guard: (near-)collinear or collapsed inlier sets make
        # Kabsch ill-posed — the reference relies on its SVD solver returning
        # identity for degenerate input (Utils.cpp:360-404); we detect rank
        # deficiency of the centered cloud directly
        for cloud in (src, dst):
            ev = np.linalg.eigvalsh(np.cov(cloud.T))
            # a (near-)line or point leaves rotation about the line axis
            # unconstrained: second principal direction must carry spread
            if ev[1] < max(1e-12, 1e-5 * ev[2]):
                logging.info(f"procrustes {fA.id_str}-{fB.id_str}: "
                             f"degenerate inlier set ({ev}), identity")
                return np.eye(4)
        T = kabsch_np(src, dst)
        # residual guard (ref procrustesByCorrespondence
        # FeatureManager.cpp:1095-1127: ||src_est-dst||/n > 1e-3 between
        # temporal neighbors pauses with debug dumps — note the reference's
        # `frameB->_id-frameA->_id==1` is dead code since frameA.id>frameB.id
        # is asserted; this is the intended live check. Headless: log +
        # identity so the FAIL cascade handles it instead of a garbage pose)
        err = float(np.linalg.norm(src @ T[:3, :3].T + T[:3, 3] - dst)
                    / max(len(src), 1))
        if fA.id - fB.id == 1 and err > 1e-3:
            logging.warning(f"procrustes {fA.id_str}-{fB.id_str}: residual "
                            f"{err:.5f} > 1e-3, rejecting pose")
            return np.eye(4)
        return T

    # ------------------------------------------------------------------
    # keyframe admission (ref checkAndAddKeyframe Bundler.cpp:263-323)
    # ------------------------------------------------------------------
    def check_and_add_keyframe(self, frame: Frame) -> bool:
        if frame.id == 0:
            self.keyframes.append(frame)
            return True
        if frame.status != FrameStatus.OTHER:
            return False
        kf_cfg = self.cfg["keyframe"]
        n_valid = frame.count_valid_points()
        if n_valid < self.first_frame.count_valid_points() / 10.0:
            return False
        min_rot = np.deg2rad(kf_cfg["min_rot"])
        for kf in self.keyframes:
            # camera rotation diversity ignoring roll around camera Z
            # (host numpy: 3x3 math per keyframe)
            rot_diff = rot_geodesic_ignore_cam_z_np(
                frame.pose_in_model[:3, :3].T, kf.pose_in_model[:3, :3].T)
            if rot_diff < min_rot:
                return False
        # admission covisibility rode the final BA dispatch (computed at
        # post-BA poses inside bundle_adjust_pooled) — zero extra device
        # round-trips here when the cache covers this frame + keyframe set
        fid, cache = getattr(self, "_covis_post_ba", (None, {}))
        if fid == frame.id and all(kf.id in cache for kf in self.keyframes):
            vis = np.array([cache[kf.id] for kf in self.keyframes])
        else:
            vis = self.covisibility_many(frame, self.keyframes)
        if (vis > kf_cfg["min_visible"]).any():
            return False
        self.keyframes.append(frame)
        logging.info(f"added keyframe {frame.id_str}, "
                     f"#keyframes={len(self.keyframes)}")
        return True

    # ------------------------------------------------------------------
    # BA window selection (ref selectKeyFramesForBA Bundler.cpp:430-609):
    # default normal_orientation_nearest plus the 5 alternate strategies
    # ------------------------------------------------------------------
    def _rot_dist_ignore_z(self, fA: Frame, fB: Frame) -> float:
        return rot_geodesic_ignore_cam_z_np(fA.pose_in_model[:3, :3].T,
                                            fB.pose_in_model[:3, :3].T)

    def _n_shared_map_points(self, fA: Frame, fB: Frame) -> int:
        """Count map points observed by both frames (ref
        getCovisibleMapPoints, used by greedy_covisible_points)."""
        reg = self._map_points.get(fA.id, {})
        return sum(1 for mpt in reg.values() if fB.id in mpt)

    def _unscored_kf_pairs(self, pool):
        """Keyframe-keyframe pairs with no match entry yet (the candidates
        get_feature_match_pairs' covisibility gate could ask about)."""
        extra = []
        for a in range(len(pool)):
            for b2 in range(a + 1, len(pool)):
                fA, fB = pool[b2], pool[a]
                if fA.id < fB.id:
                    fA, fB = fB, fA
                if (fA.id, fB.id) in self.matches:
                    continue
                if np.allclose(fA.pose_in_model, np.eye(4)):
                    continue
                extra.append((fA, fB))
        return extra

    def select_keyframes_for_ba(self):
        max_ba = self.cfg["bundle"]["max_BA_frames"]
        # covis values computed here are valid until the next pose change
        # (BA) — get_feature_match_pairs runs in between with the SAME
        # poses and reuses them instead of re-dispatching
        self._covis_pre_ba = {}
        if len(self.keyframes) + 1 <= max_ba:
            frames = [self.new_frame] + [kf for kf in self.keyframes
                                         if kf is not self.new_frame]
            frames.sort(key=lambda f: f.id)
            self.local_frames = frames
            return

        method = self.cfg["bundle"].get("subset_selection_method",
                                        "normal_orientation_nearest")
        nf = self.new_frame
        kf0 = self.keyframes[0]
        pool = [kf for kf in self.keyframes if kf is not nf]

        if method == "normal_orientation_nearest":
            # covisibility with the new frame, descending (ref :501-526).
            # Unseen keyframe-keyframe candidates ride the SAME dispatch:
            # whatever window gets selected, get_feature_match_pairs' gate
            # can only ask about (kfA, kfB) pairs with no match entry yet,
            # so scoring them here makes the gate fully dispatch-free.
            # Values already computed INSIDE the ref-match dispatch (the
            # _sel_ctx fusion) arrive via _covis_seed — the steady frame
            # then needs NO covisibility dispatch at all.
            frames = {nf}
            extra = self._unscored_kf_pairs(pool)
            items = [(nf, kf) for kf in pool] + extra
            seed = getattr(self, "_covis_seed", None) or {}
            scores_all = np.empty(len(items), np.float32)
            unknown, unknown_at = [], []
            for idx, (sA, sB) in enumerate(items):
                v = seed.get((sA.id, sB.id))
                if v is None:
                    unknown.append((sA, sB))
                    unknown_at.append(idx)
                else:
                    scores_all[idx] = v
            if unknown:
                scores_all[np.asarray(unknown_at)] = \
                    self.covisibility_pairs(unknown)
            scores = scores_all[:len(pool)]
            self._covis_pre_ba = {(nf.id, kf.id): float(v)
                                  for kf, v in zip(pool, scores)}
            for (fA, fB), v in zip(extra, scores_all[len(pool):]):
                self._covis_pre_ba[(fA.id, fB.id)] = float(v)
            for i in np.argsort(-scores):
                frames.add(pool[i])
                if len(frames) == max_ba:
                    break
        elif method == "nearest_rotations":
            # rot distance (ignoring cam-Z roll) to the new frame, ascending
            # (ref :474-499)
            frames = {nf}
            dists = [self._rot_dist_ignore_z(nf, kf) for kf in pool]
            for i in np.argsort(dists):
                frames.add(pool[i])
                if len(frames) == max_ba:
                    break
        elif method == "greedy_rot":
            # grow the set by the keyframe with least cumulative rot distance
            # to the current set (ref :449-472); seeded with keyframes[0]
            frames = {nf, kf0}
            while len(frames) < max_ba:
                rest = [kf for kf in pool if kf not in frames]
                if not rest:
                    break
                cum = [sum(self._rot_dist_ignore_z(kf, f) for f in frames)
                       for kf in rest]
                frames.add(rest[int(np.argmin(cum))])
        elif method == "normal_orientation_greedy":
            # grow by max summed covisibility to the current set (ref :528-551)
            frames = {nf, kf0}
            while len(frames) < max_ba:
                rest = [kf for kf in pool if kf not in frames]
                if not rest:
                    break
                # one dispatch for the whole (frames x rest) product
                items = [(f, r) for f in frames for r in rest]
                vis = self.covisibility_pairs(items)
                sums = vis.reshape(len(frames), len(rest)).sum(axis=0)
                if sums.max() <= 0:
                    break
                frames.add(rest[int(np.argmax(sums))])
        elif method == "greedy_covisible_points":
            # grow by shared map-point count with {keyframes[0], newframe}
            # (ref :553-577)
            frames = {nf, kf0}
            refs = [kf0, nf]
            while len(frames) < max_ba:
                rest = [kf for kf in pool if kf not in frames]
                if not rest:
                    break
                counts = [sum(self._n_shared_map_points(r, kf) for r in refs)
                          for kf in rest]
                if max(counts) <= 0:
                    break
                frames.add(rest[int(np.argmax(counts))])
        elif method == "max_edge":
            # DFS over match-connected paths keyframes[0] -> newframe,
            # maximizing total match count at size max_BA (ref :579-589 +
            # maxNumEdgePathDfs :612-685). Deviation: edges come from the
            # existing match table — the reference runs the matcher inside
            # the DFS, which it itself flags "Super slow".
            frames = self._max_edge_dfs(kf0, nf, pool, max_ba) or {nf, kf0}
        elif method == "near_enough_rot":
            # smallest set connecting keyframes[0] to newframe where every
            # added frame is within 30deg plain rot geodesic of the set
            # (ref :591-599 + nearEnoughRotSearch :690-746)
            frames = self._near_enough_rot_search(kf0, nf, pool) or {nf, kf0}
        else:
            raise ValueError(
                f"unknown bundle.subset_selection_method {method!r} "
                "(ref Bundler.cpp:604-608 exits here)")

        frames = sorted(frames, key=lambda f: f.id)
        self.local_frames = frames

    def _has_match_edge(self, fA: Frame, fB: Frame) -> bool:
        if fA.id < fB.id:
            fA, fB = fB, fA
        m = self.matches.get((fA.id, fB.id))
        return m is not None and len(m["conf"]) > 0

    def _n_match_edges(self, frames) -> int:
        fl = list(frames)
        tot = 0
        for i in range(len(fl)):
            for j in range(i + 1, len(fl)):
                a, b = ((fl[i], fl[j]) if fl[i].id > fl[j].id
                        else (fl[j], fl[i]))
                m = self.matches.get((a.id, b.id))
                tot += 0 if m is None else len(m["conf"])
        return tot

    # exponential-subset searches (mirroring a reference path it flags
    # "Super slow", Bundler.cpp:449-605): cap the explored-state count so a
    # pathological pool can't hang the per-frame pipeline
    DFS_STATE_CAP = 20000

    def _max_edge_dfs(self, start: Frame, goal: Frame, pool, max_ba):
        pool = pool + [goal]
        best = {"path": None, "n": -1}
        visited = set()

        def dfs(cur, path):
            if len(visited) > self.DFS_STATE_CAP:
                return
            key = frozenset(f.id for f in path)
            if key in visited:
                return
            visited.add(key)
            if len(path) == max_ba:
                if goal in path:
                    n = self._n_match_edges(path)
                    if n > best["n"]:
                        best["path"], best["n"] = set(path), n
                return
            for kf in pool:
                if kf in path or not self._has_match_edge(cur, kf):
                    continue
                dfs(kf, path | {kf})

        dfs(start, {start})
        return best["path"]

    def _near_enough_rot_search(self, start: Frame, goal: Frame, pool):
        pool = pool + [goal]
        best = {"path": None}
        visited = set()
        near_thres = np.deg2rad(30.0)

        def plain_rot(fA, fB):
            R1 = fA.pose_in_model[:3, :3]
            R2 = fB.pose_in_model[:3, :3]
            return np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1, 1))

        def dfs(cur, path):
            if len(visited) > self.DFS_STATE_CAP:
                return
            key = frozenset(f.id for f in path)
            if key in visited:
                return
            visited.add(key)
            if best["path"] is not None and len(path) > len(best["path"]):
                return
            if goal in path:
                if best["path"] is None or len(path) < len(best["path"]):
                    best["path"] = set(path)
                return
            for kf in pool:
                if kf in path:
                    continue
                if not any(plain_rot(kf, f) < near_thres for f in path):
                    continue
                dfs(kf, path | {kf})

        dfs(start, {start})
        return best["path"]

    # ------------------------------------------------------------------
    # match-pair gating (ref getFeatureMatchPairs Bundler.cpp:781-807)
    # ------------------------------------------------------------------
    def get_feature_match_pairs(self, frames):
        min_vis = self.cfg["bundle"]["non_neighbor_min_visible"]
        cands = []
        for i in range(len(frames)):
            for j in range(i + 1, len(frames)):
                fA, fB = frames[j], frames[i]
                if (fA.id, fB.id) in self.matches:
                    continue
                if np.allclose(fA.pose_in_model, np.eye(4)):
                    continue
                cands.append((fA, fB))
        pairs = []
        # ONE dispatch for the whole covisibility gate (round-2: one
        # dispatch per source frame); values already computed by
        # select_keyframes_for_ba under the SAME poses are reused, which
        # makes this dispatch-free in the steady state (all candidates are
        # (new_frame, keyframe) pairs scored during window selection)
        cache = getattr(self, "_covis_pre_ba", {})
        vis = np.empty(len(cands), np.float32)
        unknown, unknown_at = [], []
        for idx, (fA, fB) in enumerate(cands):
            v = cache.get((fA.id, fB.id))  # NOT symmetric: source is fA
            if v is None:
                unknown.append((fA, fB))
                unknown_at.append(idx)
            else:
                vis[idx] = v
        self._covis_gate_pending = set()
        if unknown and getattr(self, "_defer_covis_gate", False):
            # the fused matcher computes covisibility INSIDE its one
            # dispatch — pass the unknowns through and let
            # match_pairs_fused apply the gate (saves a dispatch + sync)
            for idx, (fA, fB) in zip(unknown_at, unknown):
                vis[idx] = np.inf
                self._covis_gate_pending.add((fA.id, fB.id))
        elif unknown:
            vis[np.asarray(unknown_at)] = self.covisibility_pairs(unknown)
        for (fA, fB), v in zip(cands, vis):
            if v < min_vis:
                self.matches[(fA.id, fB.id)] = None
            else:
                pairs.append((fA, fB))
        return pairs

    # ------------------------------------------------------------------
    # debug artifacts (SPDLOG tiers; ref FeatureManager::vizCorresBetween
    # FeatureManager.cpp:445-464 and OptimizerGpu savePoses LossGPU.cpp:26-46)
    # ------------------------------------------------------------------
    def viz_corres_between(self, fA: Frame, fB: Frame, tag: str):
        """Side-by-side match visualization (SPDLOG>=3), lines as cv2.line
        draws them (`utils/viz.py::draw_line`), written as an RGB PNG."""
        if int(self.cfg.get("SPDLOG", 1)) < 3:
            return
        m = self.matches.get((fA.id, fB.id))
        canvas = np.concatenate([fA.color, fB.color], axis=1).copy()
        if m is not None and len(m["uvA"]) > 0:
            # deterministic per-match colors from one hash, no RNG objects
            seeds = (m["uvA"][:, 0].astype(np.int64) * 7919
                     + m["uvA"][:, 1].astype(np.int64))
            colors = np.stack([(seeds * p) % 195 + 60
                               for p in (2654435761, 805459861, 40503)],
                              axis=-1).astype(int)
            for (uA, vA), (uB, vB), c in zip(m["uvA"], m["uvB"], colors):
                draw_line(canvas, (int(uA), int(vA)),
                          (int(uB) + fA.W, int(vB)), tuple(int(x) for x in c),
                          1)
        out_dir = os.path.join(self.cfg["debug_dir"], fA.id_str)
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(
            out_dir, f"corres_{fA.id_str}_{fB.id_str}_{tag}.png"), canvas)

    def _save_ba_poses(self, frames, tag: str):
        """Pre/post-BA pose dumps (SPDLOG>=2)."""
        if int(self.cfg.get("SPDLOG", 1)) < 2 or self.new_frame is None:
            return
        out_dir = os.path.join(self.cfg["debug_dir"], self.new_frame.id_str)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"opt_{tag}_poses.txt"), "w") as f:
            for fr in frames:
                np.savetxt(f, fr.pose_in_model)
        with open(os.path.join(out_dir, "opt_frames.txt"), "w") as f:
            f.write(" ".join(fr.id_str for fr in frames))

    # ------------------------------------------------------------------
    # frame eviction (ref forgetFrame + SiftManager::forgetFrame)
    # ------------------------------------------------------------------
    def forget_frame(self, frame: Frame) -> bool:
        if frame in self.keyframes and frame.status != FrameStatus.FAIL:
            return False
        self.frames.pop(frame.id, None)
        if frame in self.keyframes:
            self.keyframes.remove(frame)
        for key in [k for k in self.matches if frame.id in k]:
            del self.matches[key]
        # purge map-point observations (ref SiftManager::forgetFrame
        # FeatureManager.cpp:467-511)
        for mpt in self._map_points.pop(frame.id, {}).values():
            mpt.pop(frame.id, None)
        if (self.pool is not None and frame.pool is self.pool
                and frame.slot is not None):
            if int(self.cfg.get("SPDLOG", 1)) >= 1:
                # artifact dumps read the maps after the frame is forgotten
                frame._pull_host()
            self.pool.release(frame.id)
            frame.slot = None
        return True

    # ------------------------------------------------------------------
    # GN bundle adjustment driver (ref optimizeGPU Bundler.cpp:810-956)
    # ------------------------------------------------------------------
    def optimize(self, frames):
        pending = self.optimize_dispatch(frames)
        if pending is not None:
            self.optimize_finish(pending)

    def optimize_dispatch(self, frames):
        """Dispatch the BA program WITHOUT pulling results. Returns a
        pending handle for `optimize_finish`, or None if the frame FAILed
        before dispatch (zero global corres). Splitting dispatch from
        finish lets the orchestrator overlap the BA device time (the
        dominant device cost, docs/PERF.md) and its host pull with the
        NEXT frame's preprocessing + feature detection — the reference
        gets the same overlap from its tracker/NOF process split while
        each CUDA kernel runs async under the host loop."""
        bcfg = self.cfg["bundle"]
        idx_of = {f.id: k for k, f in enumerate(frames)}

        # EntryJ convention: j=frameA index, i=frameB index
        blocks = []
        for a in range(len(frames)):
            for b in range(a + 1, len(frames)):
                fA, fB = frames[b], frames[a]
                m = self.matches.get((fA.id, fB.id))
                if m is not None and len(m["conf"]) > 0:
                    blocks.append((idx_of[fA.id], idx_of[fB.id], m))

        if not blocks:
            logging.info(f"frame {self.new_frame.id_str}: zero global corres,"
                         " FAIL")
            self.new_frame.status = FrameStatus.FAIL
            return

        N = len(frames)
        slots = np.array([self._slot(f) for f in frames], np.int64)
        arrays = dict(slots=slots, slot_live=np.ones(N, np.float32),
                      poses0=np.stack([f.pose_in_model for f in frames])
                      .astype(np.float32),
                      K=np.asarray(frames[0].K, np.float32))
        arrays.update(corres_arrays(blocks))
        C = int(arrays["corr_valid"].sum())
        scales = (bcfg["image_downscale"]
                  if isinstance(bcfg["image_downscale"], (list, tuple))
                  else [bcfg["image_downscale"]])
        update_flags = np.zeros(N, np.float32)
        for k, f in enumerate(frames):
            if k > 0 and not f.nerfed:
                update_flags[k] = 1.0
        arrays["update_flags"] = update_flags

        # dense-pair pruning (exact): pairs where BOTH frames are pinned
        # (frame 0 / nerfed) contribute zero gradient but would pay the
        # full association gather (BA's dominant cost). The reference also
        # drops pairs whose RELATIVE ROTATION exceeds icp_pose_rot_thres
        # (geodesic, SolverBundling.cu:48-55 at the entry poses) — frames
        # viewing the object from opposite sides share no surface.
        rot_thres = np.deg2rad(float(bcfg.get("icp_pose_rot_thres", 60)))

        def _rot_ok(i, j):
            R = frames[i].pose_in_model[:3, :3] \
                @ frames[j].pose_in_model[:3, :3].T
            cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
            return np.arccos(cos) < rot_thres

        live_pairs = [(i, j) for i in range(N) for j in range(i + 1, N)
                      if (update_flags[i] > 0 or update_flags[j] > 0)
                      and _rot_ok(i, j)]
        # the pair rows padded to all N(N-1)/2 pairs with masked-out rows,
        # which also keep the shapes non-empty when every pair is pruned
        P = max(1, N * (N - 1) // 2)
        pair_ij = np.tile(np.array([0, min(1, N - 1)], np.int64), (P, 1))
        pair_valid = np.zeros(P, np.float32)
        if live_pairs:
            pair_ij[:len(live_pairs)] = live_pairs
            pair_valid[:len(live_pairs)] = 1.0
        arrays.update(pair_ij=pair_ij, pair_valid=pair_valid)

        # hybrid entry association: the wide windowed search runs only on
        # the UNCERTAIN pairs — those touching the new frame (its
        # procrustes init carries the only fresh pose error) or touching a
        # frame whose converged-pose assumption does not hold: frames
        # absent from the previous successful BA window (keyframes
        # re-entering after drift, post-FAIL relocalization) and frames
        # whose pose moved since that BA wrote it (NOF sync-back). Pairs
        # of frames jointly converged by the previous BA are within the
        # /4-grid pixel quantum where single-tap projective association
        # picks the same pixel.
        last_win = getattr(self, "_last_ba_window", {})

        def _uncertain(f):
            if f is self.new_frame:
                return True
            p = last_win.get(f.id)
            return p is None or not np.array_equal(p, f.pose_in_model)

        unc = {k for k, f in enumerate(frames) if _uncertain(f)}
        nf_rows = [r for r, (i, j) in enumerate(live_pairs)
                   if i in unc or j in unc]
        # padded by rows aimed past the end, which are dropped, to the new
        # frame's N-1 pairs (the common case: no padding), or else to P
        Pw = N - 1 if len(nf_rows) <= N - 1 else P
        pair_ij_w = np.zeros((Pw, 2), np.int64)
        pair_w_dst = np.full(Pw, P, np.int64)
        pair_ij_w[:len(nf_rows)] = pair_ij[nf_rows]
        pair_w_dst[:len(nf_rows)] = nf_rows

        self._save_ba_poses(frames, "before")
        # shapes of the BA problem (association cost = live_pairs x D)
        self._last_ba_stats = {"P": len(live_pairs), "N": N, "C": C,
                               "Pw": len(nf_rows)}

        # keyframe-admission covisibility is computed at the post-BA poses
        # by the last BA call (checkAndAddKeyframe needs it right after);
        # the keyframes are padded to a power of two, and the padded rows'
        # covisibility is never read
        kfs = self.keyframes
        KF = pow2_at_least(len(kfs), KF_MIN)
        kf_slots = np.zeros(KF, np.int64)
        kf_poses = np.tile(np.eye(4, dtype=np.float32), (KF, 1, 1))
        kf_window_idx = np.full(KF, -1, np.int64)
        for k, kf in enumerate(kfs):
            kf_slots[k] = self._slot(kf)
            kf_poses[k] = kf.pose_in_model.astype(np.float32)
            kf_window_idx[k] = idx_of.get(kf.id, -1)
        admission = dict(nf_idx=np.array([idx_of[self.new_frame.id]],
                                         np.int64),
                         kf_slots=kf_slots, kf_poses=kf_poses,
                         kf_window_idx=kf_window_idx)
        thres_cos = float(np.cos(np.deg2rad(self.cfg["visible_angle"])))
        # coarse-to-fine scale loop (ref LossGPU.cpp:79-131): the sparse
        # feature-match term runs only at the FIRST scale; later scales
        # refine with the dense p2p term alone (m_localWeightsSparse
        # resized to 0 for iter>0, LossGPU.cpp:110-113)
        out = None
        for it, scale in enumerate(scales):
            factor = int(scale)
            cfg_ba = BAConfig(
                n_outer=bcfg["num_iter_outter"],
                image_downscale=factor,
                dense_dist_thres=self.cfg["p2p"]["max_dist"],
                dense_normal_thres_deg=self.cfg["p2p"]["max_normal_angle"],
                assoc_radius=int(bcfg["depth_association_radius"]),
                reassoc_iters=int(bcfg.get("reassoc_iters", 1)),
                assoc_stride_first=int(bcfg.get("assoc_stride_first", 2)),
                assoc_refine_mode=str(bcfg.get("assoc_refine_mode",
                                               "projective")),
                assoc_layout=str(bcfg.get("assoc_layout", "lane")),
                assoc_dtype=str(bcfg.get("assoc_dtype", "bf16")),
                assoc_entry_mode=str(bcfg.get("assoc_entry_mode",
                                              "hybrid")),
                early_out_delta=float(bcfg.get("early_out_delta", 1e-4)),
                robust_delta=bcfg["robust_delta"],
                w_sparse=bcfg["w_fm"] if it == 0 else 0.0,
                w_dense=bcfg["w_p2p"],
                w_dense_color=float(bcfg.get("w_dense_color", 0.0) or 0.0),
                robust_delta_color=float(
                    bcfg.get("robust_delta_color", 0.1)))

            # per-frame valid-object-point indices in the downsampled grid:
            # the dense term runs on these D points, not all h*w pixels. D
            # is the pow-2 bucket of the largest per-frame count, capped at
            # n_dense_pts; a frame above the cap is subsampled uniformly.
            flats = [np.nonzero(
                (f.fg_mask[::factor, ::factor] > 0).reshape(-1))[0]
                for f in frames]
            cap = cfg_ba.n_dense_pts
            D = 512
            while D < min(max(map(len, flats)), cap):
                D *= 2
            D = min(D, cap)
            self._last_ba_stats["D"] = D
            src_idx = np.zeros((N, D), np.int64)
            src_valid = np.zeros((N, D), bool)
            for k, flat in enumerate(flats):
                if len(flat) > D:  # uniform subsample to the budget
                    flat = flat[np.linspace(0, len(flat) - 1, D).astype(int)]
                src_idx[k, :len(flat)] = flat
                src_valid[k, :len(flat)] = True

            last = it == len(scales) - 1
            # even factors read the pool's half-res pyramid
            half = factor % 2 == 0
            pd = 2 if half else 1
            maps = dict(pool_xyzs=self.pool.xyzs_h if half else self.pool.xyzs,
                        pool_nrms=self.pool.nrms_h if half else self.pool.nrms,
                        pool_greys=None)
            if cfg_ba.w_dense_color > 0 and self.pool.greys is not None:
                maps["pool_greys"] = (self.pool.greys_h if half
                                      else self.pool.greys)
            call = dict(arrays, src_idx=src_idx, src_valid=src_valid)
            if cfg_ba.assoc_entry_mode == "hybrid":
                call.update(pair_ij_w=pair_ij_w, pair_w_dst=pair_w_dst)
            static = dict(factor=factor, cfg=cfg_ba, pre_decim=pd)
            if last:
                maps["pool_valids"] = (self.pool.valids_h if half
                                       else self.pool.valids)
                call.update(admission)
                static["covis_thres_cos"] = thres_cos
            # intermediate scales feed the next scale's assoc; the sums
            # over correspondences and pairs take the real counts
            out = self._ba(call, maps, poses_in=out, n_corr=C,
                           n_pairs=max(len(live_pairs), 1), **static)
        # the copies back start now and land while the host moves on
        return {"out": HostPull({"poses": out[0], "covis": out[1]},
                                "track.ba"),
                "frames": list(frames), "idx_of": idx_of,
                "kfs": list(kfs), "new_frame": self.new_frame}

    def optimize_finish(self, pending):
        """Pull the BA results dispatched by `optimize_dispatch` and apply
        them: admission-covis cache, abnormal-pose-jump rejection
        (ref Bundler.cpp:927-946), pose writes."""
        frames = pending["frames"]
        idx_of = pending["idx_of"]
        kfs = pending["kfs"]
        res = pending["out"].get()
        poses, covis_h = res["poses"], res["covis"]
        self._covis_post_ba = (pending["new_frame"].id,
                               {kf.id: float(covis_h[k])
                                for k, kf in enumerate(kfs)})

        # abnormal-pose-change rejection vs temporal neighbor
        # (ref Bundler.cpp:927-946)
        nf = pending["new_frame"]
        if nf.ref_frame_id == nf.id - 1 and nf.ref_frame_id in self.frames:
            ref = self.frames[nf.ref_frame_id]
            k_new = idx_of[nf.id]
            new_pose = poses[k_new].astype(np.float64)
            t_new = np.linalg.inv(new_pose)[:3, 3]
            t_ref = np.linalg.inv(ref.pose_in_model)[:3, 3]
            trans_diff = np.linalg.norm(t_new - t_ref)
            R1 = np.linalg.inv(new_pose)[:3, :3]
            R2 = np.linalg.inv(ref.pose_in_model)[:3, :3]
            cosang = np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1, 1)
            rot_diff = np.arccos(cosang)
            if trans_diff > self.cfg["ransac"]["max_trans_neighbor"]:
                logging.info(f"frame {nf.id_str} BA trans jump {trans_diff:.4f}"
                             " too big, FAIL")
                nf.status = FrameStatus.FAIL
                return
            if rot_diff > np.deg2rad(self.cfg["ransac"]["max_rot_deg_neighbor"]):
                logging.info(f"frame {nf.id_str} BA rot jump too big, FAIL")
                nf.status = FrameStatus.FAIL
                return

        for k, f in enumerate(frames):
            f.pose_in_model = poses[k].astype(np.float64)
        # record the jointly-converged window for the next dispatch's
        # hybrid entry routing: a pair is "certain" only if both frames
        # were in THIS window and their poses are still exactly these
        self._last_ba_window = {f.id: f.pose_in_model.copy()
                                for f in frames}
        self._save_ba_poses(frames, "after")
