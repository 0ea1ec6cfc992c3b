"""Device-resident frame-map pool and the per-frame tracking programs.

Port of `bundlesdf_tpu/tracker/pool.py`. All live frames' preprocessed
maps (xyz, normals, depth, validity, and a half-res strided pyramid) live
in one set of stacked device tensors, written in place by slot; slot
bookkeeping (frame id <-> slot, free list) stays on the host. The
per-frame device work is:

  - `preprocess_into_pool`: the depth chain (erode -> 2x bilateral ->
    xyz -> normals -> edge filter -> mask), the slot write and the
    valid-point count (ref Frame.cpp:24-334 + :453-464).
  - `covis_core`: covisibility for a batch of (slot, T) items
    (ref Frame.h:122-165).
  - `orb_lift_ransac_slots`: batched ORB matching -> stable top-M match
    selection by confidence -> lifting from the pool -> 3D gating ->
    multi-pair RANSAC, optionally with the device procrustes of the
    ref-match pair and the window-selection covisibility (ref
    rawMatchesToCorres FeatureManager.cpp:2720-2769 + cuda_ransac.cu +
    procrustesByCorrespondence :1050-1129).
  - `lift_ransac_slots`: the same from host-given pixel matches.

Capacity doubles when the pool is full. Frame ids never alias slots: a
released slot returns to the free list.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.matcher.classical import orb_match_core
from bundlesdf_tpu_torch.ops.preprocess import preprocess_depth_frame
from bundlesdf_tpu_torch.tracker.ransac import ransac_pose
from bundlesdf_tpu_torch.utils.profiling import span
from bundlesdf_tpu_torch.utils.se3 import kabsch
from bundlesdf_tpu_torch.utils.transfer import HostPull

_VALID_MIN = 0.1


def _inv(T):
    """Batched 4x4 inverse without a host sync."""
    return torch.linalg.inv_ex(T)[0]


def _write_slot(pool_tensors, slot, xyz, nrm, d, valid):
    xyzs, nrms, depths, valids, xyzs_h, nrms_h, valids_h = pool_tensors
    xyzs[slot] = xyz
    nrms[slot] = nrm
    depths[slot] = d
    valids[slot] = valid
    xyzs_h[slot] = xyz[::2, ::2]
    nrms_h[slot] = nrm[::2, ::2]
    valids_h[slot] = valid[::2, ::2]


def preprocess_into_pool(xyzs, nrms, depths, valids, xyzs_h, nrms_h,
                         valids_h, slot, depth, K, mask,
                         erode_radius=1, erode_diff=0.001, erode_ratio=0.8,
                         bf_radius=2, sigma_d=2.0, sigma_r=100000.0,
                         zfar=1.0,
                         edge_angle_thres_rad=10.0 * math.pi / 180.0):
    """Depth chain + in-place pool slot write (full res and the half-res
    strided pyramid, xyzs_h == xyzs[:, ::2, ::2], which covisibility and
    BA read) + valid count. Returns the (device) valid-point count."""
    d, xyz, nrm = preprocess_depth_frame(
        depth, K, mask, erode_radius=erode_radius, erode_diff=erode_diff,
        erode_ratio=erode_ratio, bf_radius=bf_radius, sigma_d=sigma_d,
        sigma_r=sigma_r, zfar=zfar,
        edge_angle_thres_rad=edge_angle_thres_rad)
    valid = (d > _VALID_MIN) & (mask > 0)
    _write_slot((xyzs, nrms, depths, valids, xyzs_h, nrms_h, valids_h),
                slot, xyz, nrm, d, valid)
    return valid.sum()


def mask_pool_slot(xyzs, nrms, depths, valids, xyzs_h, nrms_h, valids_h,
                   slot, mask):
    """Re-invalidate a pooled frame by a (possibly shrunken) mask
    (ref invalidatePixelsByMask Frame.cpp:432-451), in place. Returns the
    new valid count."""
    keep = mask > 0
    d = torch.where(keep, depths[slot], 0.0)
    xyz = torch.where(keep[..., None], xyzs[slot], 0.0)
    nrm = torch.where(keep[..., None], nrms[slot], 0.0)
    valid = valids[slot] & keep
    _write_slot((xyzs, nrms, depths, valids, xyzs_h, nrms_h, valids_h),
                slot, xyz, nrm, d, valid)
    return valid.sum()


def covis_core(xyzs, nrms, valids, slots, Ts, thres_cos):
    """Covisibility of each (source slot, A_in_B transform) item: the
    fraction of the source's valid points whose normals face camera B.
    @slots: (P,) int; @Ts: (P,4,4). Expects maps already at the
    covisibility resolution (the pool's half-res pyramid, i.e. the
    reference's stride-2 loop, Frame.h:142-165). Returns (P,) float32."""
    P = slots.shape[0]
    xyz = xyzs[slots].reshape(P, -1, 3)
    nrm = nrms[slots].reshape(P, -1, 3)
    ok = valids[slots].reshape(P, -1)
    ok = ok & (torch.linalg.norm(nrm, dim=-1) > 1e-6)
    R = Ts[:, :3, :3].transpose(1, 2)
    p = xyz @ R + Ts[:, None, :3, 3]
    n = nrm @ R
    p_hat = -p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                             min=1e-12)
    n_hat = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-12)
    dot = torch.sum(p_hat * n_hat, dim=-1)
    vis = torch.sum((dot > thres_cos) & ok, dim=1)
    return vis.float() / (torch.sum(ok, dim=1).float() + 1e-7)


def _lift_ransac_core(xyzs, nrms, slots_a, slots_b, uvA, uvB, valid, conf,
                      TA, TB, cap_t, cap_r, seed, inlier_dist,
                      cos_normal_angle, n_trials: int, sample_idx=None):
    cap, H, W, _ = xyzs.shape
    xyz_flat = xyzs.reshape(cap * H * W, 3)
    nrm_flat = nrms.reshape(cap * H * W, 3)

    def lift(slots, uv):
        r = slots[:, None].long() * (H * W) + uv[..., 1].long() * W \
            + uv[..., 0].long()
        return xyz_flat[r], nrm_flat[r]

    pA, nA = lift(slots_a, uvA)                               # (P,M,3)
    pB, nB = lift(slots_b, uvB)
    ok = valid & (pA[..., 2] > _VALID_MIN) & (pB[..., 2] > _VALID_MIN)

    # model-frame points for RANSAC (ref runRansacMultiPairGPU transforms
    # by the current pose estimates)
    RA, RB = TA[:, :3, :3], TB[:, :3, :3]
    pA_m = torch.einsum("pij,pmj->pmi", RA, pA) + TA[:, None, :3, 3]
    pB_m = torch.einsum("pij,pmj->pmi", RB, pB) + TB[:, None, :3, 3]
    nA_m = torch.einsum("pij,pmj->pmi", RA, nA)
    nB_m = torch.einsum("pij,pmj->pmi", RB, nB)
    out = ransac_pose(pA_m, pB_m, nA_m, nB_m, conf, ok, inlier_dist,
                      cos_normal_angle, cap_t, cap_r, n_trials=n_trials,
                      seed=seed, sample_idx=sample_idx)
    return {"pA_cam": pA, "pB_cam": pB, "nA_cam": nA, "nB_cam": nB,
            "ok": ok, "inlier_mask": out["inlier_mask"] & ok,
            "n_inliers": out["n_inliers"]}


def lift_ransac_slots(xyzs, nrms, slots_a, slots_b, uvA, uvB, valid, conf,
                      TA, TB, cap_t, cap_r, seed, inlier_dist,
                      cos_normal_angle, n_trials: int = 2000,
                      sample_idx=None):
    """Correspondence lifting + gating + multi-pair RANSAC.

    @slots_a/@slots_b: (P,) pool slots; @uvA/@uvB: (P,M,2) int pixel
    coords (clipped in-bounds); @valid: (P,M) raw in-bounds mask;
    @conf: (P,M); @TA/@TB: (P,4,4) current poses (cam-in-model);
    @cap_t/@cap_r: (P,) per-pair RANSAC pose caps; @seed: RNG seed of the
    trial draw (or @sample_idx, see `ransac_pose`).

    Returns per-match camera-frame lifts (pA_cam,pB_cam,nA_cam,nB_cam:
    (P,M,3)), the 3D-validity gate `ok` (P,M), RANSAC `inlier_mask` (P,M)
    and `n_inliers` (P,)."""
    return _lift_ransac_core(xyzs, nrms, slots_a, slots_b, uvA, uvB, valid,
                             conf, TA, TB, cap_t, cap_r, seed, inlier_dist,
                             cos_normal_angle, n_trials, sample_idx)


def _weighted_mid_eig_ok(pts, w, wsum):
    """Degeneracy gate on an inlier cloud (the host procrustes guard: the
    second principal direction of the weighted covariance must carry
    spread)."""
    mu = torch.sum(pts * w[:, None], dim=0) / wsum
    X = (pts - mu) * torch.sqrt(w)[:, None]
    C = X.T @ X / wsum
    ev = torch.linalg.eigvalsh(C)            # ascending
    return ev[1] >= torch.clamp(1e-5 * ev[2], min=1e-12)


def _procrustes_and_covis(out, TA, TB, slots_a, xyzs_h, nrms_h, valids_h,
                          covis_thres_cos, sel_kf_poses, sel_kf_slots,
                          sel_extra_slots, sel_extra_Ts, proc_gates):
    """Device procrustes for pair 0 (the (new_frame, ref) match) plus the
    window-selection covisibility at the post-procrustes pose (ref
    procrustesByCorrespondence FeatureManager.cpp:1050-1129, then
    selectKeyFramesForBA covisibility Bundler.cpp:501-526).

    @proc_gates: (min_match_with_ref, min_match_after_ransac, kept_cap,
    is_neighbor) float32. The offset collapses to identity under the
    conditions the host logic would not apply it (too few kept matches,
    degenerate inlier cloud, neighbor residual guard), so the covisibility
    is evaluated at the pose the host adopts."""
    min_ref, min_after, kept_cap, is_nb = proc_gates
    w = (out["inlier_mask"][0] & out["ok"][0]).float()
    n_in = torch.sum(w)
    TA0, TB0 = TA[0], TB[0]
    src = out["pA_cam"][0] @ TA0[:3, :3].T + TA0[:3, 3]
    dst = out["pB_cam"][0] @ TB0[:3, :3].T + TB0[:3, 3]
    T_off = kabsch(src, dst, weights=w)
    wsum = n_in + 1e-9
    # residual guard (host: ||src@R.T+t - dst||_F / n > 1e-3 between
    # temporal neighbors rejects the pose)
    diff = src @ T_off[:3, :3].T + T_off[:3, 3] - dst
    err = torch.sqrt(torch.sum(w * torch.sum(diff * diff, -1))) / wsum
    use = ((torch.minimum(n_in, kept_cap) >= min_ref)
           & (n_in >= torch.clamp(min_after, min=5.0))
           & _weighted_mid_eig_ok(src, w, wsum)
           & _weighted_mid_eig_ok(dst, w, wsum)
           & ~((is_nb > 0) & (err > 1e-3)))
    eye = torch.eye(4, dtype=T_off.dtype, device=T_off.device)
    T_off = torch.where(use, T_off, eye)
    new_pose = T_off @ TA0
    Ts_kf = _inv(sel_kf_poses) @ new_pose  # nf cam -> kf cam
    src_slots = torch.full(sel_kf_slots.shape, 0, dtype=slots_a.dtype,
                           device=slots_a.device) + slots_a[0]
    res = {"proc_offset": T_off, "proc_use": use, "proc_err": err,
           "covis_kf": covis_core(xyzs_h, nrms_h, valids_h, src_slots,
                                  Ts_kf, covis_thres_cos)}
    if sel_extra_slots is not None:
        res["covis_extra"] = covis_core(xyzs_h, nrms_h, valids_h,
                                        sel_extra_slots, sel_extra_Ts,
                                        covis_thres_cos)
    return res


def topk_stable(x, k: int):
    """Top-@k along dim 1, descending, lower index first among ties (the
    order `jax.lax.top_k` guarantees). Returns (values, indices)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def orb_lift_ransac_slots(xyzs, nrms, bitsA, bitsB, uvfA, uvfB, nA, nB,
                          slots_a, slots_b, TA, TB, cap_t, cap_r, seed,
                          inlier_dist, cos_normal_angle, ratio: float,
                          nbits: int, m_cap: int, n_trials: int = 2000,
                          k_pull: int = 0, xyzs_h=None, nrms_h=None,
                          valids_h=None, covis_thres_cos=None,
                          ratio_loose: float = 0.0, min_strict: int = 0,
                          sel_kf_slots=None, sel_kf_poses=None,
                          sel_extra_slots=None, sel_extra_Ts=None,
                          proc_gates=None, sample_idx=None):
    """The whole find_corres device path: batched ORB matching (mutual
    ratio test) -> top-@m_cap match selection by confidence -> lifting
    from the pool -> 3D gating -> multi-pair RANSAC.

    @bitsA/@bitsB: (P,F,nbits) +/-1 int8 descriptor expansions (or
    length-P sequences of (F,nbits)); @uvfA/@uvfB: (P,F,2) float32
    full-res keypoint coords (or sequences); @nA/@nB: (P,) real feature
    counts. Other args as `lift_ransac_slots`.

    Returns the lift_ransac_slots dict plus `uvA`/`uvB` (P,m_cap,2) int32
    matched pixel coords, `conf` (P,m_cap), and `n_raw` (P,) pre-RANSAC
    match counts. With @k_pull > 0 the result is instead compacted to the
    post-RANSAC inliers (top-k_pull by confidence, uv as int16, no match
    normals). With the selection args it also carries the ref-match
    procrustes + selection covisibility (`_procrustes_and_covis`); with
    the half-res maps alone, the per-pair covisibility `covis` (source A,
    T = inv(poseB) @ poseA) for the deferred match-pair gate.
    """
    stack = (lambda a: a if torch.is_tensor(a) else torch.stack(list(a)))
    bitsA, bitsB, uvfA, uvfB = map(stack, (bitsA, bitsB, uvfA, uvfB))
    match = orb_match_core(bitsA, bitsB, nA, nB, ratio, nbits, ratio_loose,
                           min_strict)
    conf_all = torch.where(match["ok"], 1.0 / (1.0 + match["dist"] / 64.0),
                           0.0)                                   # (P,F)
    n_raw = torch.sum(match["ok"], dim=1).to(torch.int32)
    conf, sel = topk_stable(conf_all, m_cap)                      # (P,M)
    valid = conf > 0
    uvA_f = torch.gather(uvfA, 1, sel[..., None].expand(-1, -1, 2))
    j_sel = torch.gather(match["j"], 1, sel)
    uvB_f = torch.gather(uvfB, 1, j_sel[..., None].expand(-1, -1, 2))
    H, W = xyzs.shape[1:3]
    hi = torch.tensor([W - 1, H - 1], dtype=torch.int32, device=xyzs.device)
    uvA = torch.minimum(torch.clamp(torch.round(uvA_f).to(torch.int32),
                                    min=0), hi)
    uvB = torch.minimum(torch.clamp(torch.round(uvB_f).to(torch.int32),
                                    min=0), hi)
    out = _lift_ransac_core(xyzs, nrms, slots_a, slots_b, uvA, uvB, valid,
                            conf, TA, TB, cap_t, cap_r, seed, inlier_dist,
                            cos_normal_angle, n_trials, sample_idx)
    sel_res = None
    if sel_kf_slots is not None:
        sel_res = _procrustes_and_covis(out, TA, TB, slots_a, xyzs_h, nrms_h,
                                        valids_h, covis_thres_cos,
                                        sel_kf_poses, sel_kf_slots,
                                        sel_extra_slots, sel_extra_Ts,
                                        proc_gates)
    covis = None
    if xyzs_h is not None and sel_kf_slots is None:
        Ts = _inv(TB) @ TA
        covis = covis_core(xyzs_h, nrms_h, valids_h, slots_a, Ts,
                           covis_thres_cos)
    if k_pull <= 0:
        out.update(uvA=uvA, uvB=uvB, conf=conf, n_raw=n_raw)
        if covis is not None:
            out["covis"] = covis
        if sel_res is not None:
            out.update(sel_res)
        return out
    score = torch.where(out["inlier_mask"], conf, 0.0)
    sc, order = topk_stable(score, min(k_pull, conf.shape[1]))

    def take(a):
        idx = order[..., None].expand(-1, -1, a.shape[2]) if a.dim() == 3 \
            else order
        return torch.gather(a, 1, idx)

    res = {"uvA": take(uvA).to(torch.int16),
           "uvB": take(uvB).to(torch.int16),
           "conf": sc,
           "pA_cam": take(out["pA_cam"]), "pB_cam": take(out["pB_cam"]),
           "n_in": torch.sum(out["inlier_mask"], dim=1).to(torch.int32),
           "n_inliers": out["n_inliers"], "n_raw": n_raw}
    if covis is not None:
        res["covis"] = covis
    if sel_res is not None:
        res.update(sel_res)
    return res


class FramePool:
    """Fixed-capacity stacked frame maps on @device; host-side slot
    bookkeeping. All maps are float32 (bf16 xyz would cost ~2 mm at 0.5 m,
    too coarse against the 5 mm RANSAC inlier gate)."""

    def __init__(self, H, W, cap=16, device="cuda"):
        self.H, self.W = H, W
        self.cap = cap
        self.device = resolve_device(device)
        self.Hh, self.Wh = -(-H // 2), -(-W // 2)
        z = dict(device=self.device)
        self.xyzs = torch.zeros((cap, H, W, 3), **z)
        self.nrms = torch.zeros((cap, H, W, 3), **z)
        self.depths = torch.zeros((cap, H, W), **z)
        self.valids = torch.zeros((cap, H, W), dtype=torch.bool, **z)
        # half-res strided pyramid (== arr[:, ::2, ::2]): covisibility and
        # BA read these instead of gathering + striding the full maps
        self.xyzs_h = torch.zeros((cap, self.Hh, self.Wh, 3), **z)
        self.nrms_h = torch.zeros((cap, self.Hh, self.Wh, 3), **z)
        self.valids_h = torch.zeros((cap, self.Hh, self.Wh),
                                    dtype=torch.bool, **z)
        # grey intensity maps for the dense photometric BA term, allocated
        # by the first set_grey (no memory while the term is off)
        self.greys = None
        self.greys_h = None
        self.slot_of: dict[int, int] = {}
        self._free = list(range(cap))

    @property
    def tensors(self):
        return (self.xyzs, self.nrms, self.depths, self.valids, self.xyzs_h,
                self.nrms_h, self.valids_h)

    def _alloc(self, frame_id: int) -> int:
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.slot_of[frame_id] = slot
        return slot

    def _grow(self):
        """Double the capacity (one device reallocation per doubling)."""
        new_cap = self.cap * 2

        def grow(a):
            return None if a is None else torch.cat(
                [a, torch.zeros((new_cap - self.cap,) + a.shape[1:],
                                dtype=a.dtype, device=a.device)])

        (self.xyzs, self.nrms, self.depths, self.valids, self.xyzs_h,
         self.nrms_h, self.valids_h, self.greys, self.greys_h) = map(
            grow, (*self.tensors, self.greys, self.greys_h))
        self._free.extend(range(self.cap, new_cap))
        self.cap = new_cap

    def release(self, frame_id: int):
        slot = self.slot_of.pop(frame_id, None)
        if slot is not None:
            self._free.append(slot)

    # -- writes ------------------------------------------------------------

    def insert_preprocessed(self, frame_id, depth, K, mask, dp_cfg):
        """Run the depth chain into a new slot. Returns (slot, device
        valid-point count)."""
        slot = self._alloc(frame_id)
        dev = self.device
        with span("pull.track.pool_upload"):  # host->device copies: waits
            inputs = (torch.as_tensor(np.asarray(depth, np.float32),
                                      device=dev),
                      torch.as_tensor(np.asarray(K, np.float32), device=dev),
                      torch.as_tensor(np.asarray(mask), device=dev))
        n_valid = preprocess_into_pool(
            *self.tensors, slot, *inputs,
            erode_radius=int(dp_cfg["erode"]["radius"]),
            erode_diff=dp_cfg["erode"]["diff"],
            erode_ratio=dp_cfg["erode"]["ratio"],
            bf_radius=int(dp_cfg["bilateral_filter"]["radius"]),
            sigma_d=dp_cfg["bilateral_filter"]["sigma_D"],
            sigma_r=dp_cfg["bilateral_filter"]["sigma_R"],
            zfar=dp_cfg["zfar"],
            edge_angle_thres_rad=dp_cfg["edge_normal_thres"]
            * math.pi / 180.0)
        return slot, n_valid

    def insert_maps(self, frame_id, depth, xyz, nrm, valid):
        """Adopt already-preprocessed maps (standalone frames)."""
        slot = self._alloc(frame_id)
        dev = self.device
        if not torch.is_tensor(xyz):       # host maps: one copy each
            xyz, nrm, depth, valid = (torch.from_numpy(np.array(a)) for a in
                                      (xyz, nrm, depth, valid))
        f32 = dict(dtype=torch.float32, device=dev)
        _write_slot(self.tensors, slot, xyz.to(**f32), nrm.to(**f32),
                    depth.to(**f32), valid.to(dev))
        return slot

    def set_grey(self, frame_id, grey):
        """Store a frame's grey intensity map (0..1 float32) for the dense
        photometric BA term. The half-res twin is a centered separable
        [1,2,1]/4 pyramid step, which keeps half-res sample i at full
        pixel 2i exactly, matching the strided geometry grid."""
        slot = self.slot_of[frame_id]
        g = np.asarray(grey, np.float32)
        assert g.shape == (self.H, self.W), (g.shape, (self.H, self.W))
        if self.greys is None:
            self.greys = torch.zeros((self.cap, self.H, self.W),
                                     device=self.device)
            self.greys_h = torch.zeros((self.cap, self.Hh, self.Wh),
                                       device=self.device)
        gp = np.pad(g, ((1, 1), (1, 1)), mode="edge")
        sm = (gp[:-2] + 2.0 * gp[1:-1] + gp[2:]) * 0.25
        sm = (sm[:, :-2] + 2.0 * sm[:, 1:-1] + sm[:, 2:]) * 0.25
        self.greys[slot] = torch.from_numpy(g).to(self.device)
        self.greys_h[slot] = torch.from_numpy(
            np.ascontiguousarray(sm[::2, ::2], np.float32)).to(self.device)

    def apply_mask(self, frame_id, mask):
        slot = self.slot_of[frame_id]
        return mask_pool_slot(*self.tensors, slot,
                              torch.as_tensor(np.asarray(mask),
                                              device=self.device))

    # -- reads -------------------------------------------------------------

    def host_maps(self, frame_id):
        """One frame's (depth, xyz, normal) maps as host numpy arrays."""
        slot = self.slot_of[frame_id]
        h = HostPull({"d": self.depths[slot], "x": self.xyzs[slot],
                      "n": self.nrms[slot]}, "track.pool").get()
        return h["d"], h["x"], h["n"]
