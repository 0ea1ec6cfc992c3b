"""Multi-frame Gauss-Newton bundle adjustment on SE(3).

Port of `bundlesdf_tpu/tracker/ba.py` (re-design of the BundleFusion-
derived CUDA solver, `cuda/Solver/SolverBundling.cu`, `SBA.cu`,
`LossGPU.cpp`): the problem is tiny (<=10 frames x 6 DoF), so each outer
iteration builds the residuals with fixed dense associations, assembles
J^T J (<=60x60) and solves it exactly. Semantics preserved:
  - sparse feature term ||T_i p_i - T_j p_j||^2 over EntryJ-style
    correspondences (`SolverBundlingEquationsLie.h:37-67`)
  - dense point-to-plane depth ICP on downsampled grids, associated by
    windowed projective nearest-neighbor with dist/normal gates and score
    = (1-dot) + dist/thres (`SolverBundlingDenseUtil.h:126-184`), or by a
    single projective tap; the window / projective / hybrid entry modes
    and the reassociation schedule of the JAX package
  - Huber robust weight on the dense residual (`SolverBundling.cu:201-218`)
  - optional dense photometric term (`SolverBundling.cu:236-257`)
  - frame pin flags (frame 0 + nerfed keyframes, `Bundler.cpp:906-915`)
  - 7 outer GN iterations with the convergence early-out

The Jacobian is the analytic left-perturbation one at delta = 0 (what
`jax.jacfwd` of the JAX residual evaluates): for a world point g and a
tangent (t, w), d(exp(delta) T p)/d delta = [I, -hat(g)]. The early-out
runs all `n_outer` iterations and freezes the poses with `torch.where`
once the update norm falls below `early_out_delta`, so the solve never
waits on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bundlesdf_tpu_torch.utils.profiling import span
from bundlesdf_tpu_torch.utils.se3 import hat, se3_exp


@dataclass(frozen=True)
class BAConfig:
    """Field names and defaults of the JAX package's BAConfig; see its
    docstrings for the measurements behind each default. `assoc_layout`
    picks a TPU memory layout there and is accepted and ignored here."""
    n_outer: int = 7
    image_downscale: int = 4
    dense_dist_thres: float = 0.01      # p2p.max_dist
    dense_normal_thres_deg: float = 20  # p2p.max_normal_angle
    dense_depth_min: float = 0.1
    dense_depth_max: float = 9999.0
    assoc_radius: int = 5               # bundle.depth_association_radius
    assoc_radius_refine: int = 2
    assoc_stride_first: int = 2
    reassoc_iters: int = 1
    assoc_refine_mode: str = "projective"
    assoc_entry_mode: str = "hybrid"
    assoc_layout: str = "lane"
    # "bf16": gather + score the candidate windows in bfloat16, then
    # re-fetch the selected candidate in float32 and recompute its gates;
    # "f32": exact scoring
    assoc_dtype: str = "bf16"
    early_out_delta: float = 1e-4
    n_dense_pts: int = 4096
    robust_delta: float = 0.005
    w_sparse: float = 1.0               # bundle.w_fm
    w_dense: float = 1.0                # bundle.w_p2p
    w_dense_color: float = 0.0          # bundle.w_dense_color
    robust_delta_color: float = 0.03
    damping: float = 1e-6


def _inv(T):
    return torch.linalg.inv_ex(T)[0]


def _cos_deg(deg, device):
    """cos of @deg degrees, computed in float32 as the JAX package does."""
    with span("pull.track.ba_const"):  # a host->device copy: a wait
        t = torch.tensor(float(deg), dtype=torch.float32, device=device)
    return torch.cos(torch.deg2rad(t))


def _to_int(x):
    """Rounded float -> int32, clamped away from int32 overflow."""
    return torch.clamp(x, -1e9, 1e9).to(torch.int32)


def _pose_update(poses, delta, flags):
    """poses <- exp(delta) @ poses, zeroing pinned frames' deltas."""
    delta = delta.reshape(-1, 6) * flags[:, None]
    with span("pull.track.ba_pose"):  # se3_exp uploads a constant: a wait
        step = se3_exp(delta)
    return step @ poses


def _huber(res0, delta):
    absr = torch.abs(res0)
    return torch.where(absr <= delta, 1.0,
                       delta / torch.clamp(absr, min=1e-12))


def _src_points(xyz, nrm, src_idx):
    """Per-frame src point/normal gathers: (N,D,3) each."""
    N = xyz.shape[0]
    idx = src_idx.long()[..., None].expand(-1, -1, 3)
    return (torch.gather(xyz.reshape(N, -1, 3), 1, idx),
            torch.gather(nrm.reshape(N, -1, 3), 1, idx))


def _project_pairs(poses, xyz, nrm, K, pair_ij, src_idx, src_valid,
                   cfg: BAConfig):
    """Shared front of both association modes: src points of frame j in
    the tgt frame i's camera, their pixel, and the src validity."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    src_p_all, src_n_all = _src_points(xyz, nrm, src_idx)
    i, j = pair_ij[:, 0].long(), pair_ij[:, 1].long()
    T = _inv(poses[i]) @ poses[j]          # src(j) cam -> tgt(i) cam
    src_p = src_p_all[j]
    src_n = src_n_all[j]
    src_ok = (src_valid[j] & (src_p[..., 2] > cfg.dense_depth_min)
              & (src_p[..., 2] < cfg.dense_depth_max)
              & (torch.abs(src_n[..., 0]) > 0))
    Rt = T[:, :3, :3].transpose(1, 2)
    p_tgt = src_p @ Rt + T[:, None, :3, 3]
    n_tgt_of_src = src_n @ Rt
    z = torch.clamp(p_tgt[..., 2], min=1e-6)
    u = torch.round(p_tgt[..., 0] / z * fx + cx)
    v = torch.round(p_tgt[..., 1] / z * fy + cy)
    return i, src_p, src_ok, p_tgt, n_tgt_of_src, u, v


def _dense_associate(poses, xyz, nrm, K, pair_ij, src_idx, src_valid,
                     cfg: BAConfig, radius: int, stride: int = 1):
    """Windowed projective nearest-neighbor association for every ordered
    frame pair. @xyz,@nrm: (N,h,w,3) downsampled maps. @pair_ij: (P,2)
    (tgt i, src j). @src_idx/@src_valid: (N,D) flat pixel indices of the
    valid object points per frame (padded).

    Each (pair, point) scans the taps of a (2r+1)^2 window around its
    projection, rows strided by @stride; the window start is clamped so
    the whole window lies in the image. Taps are ordered row-major (the
    first minimum wins, as in the JAX package). Returns per (pair, point):
    src point in src cam, tgt point/normal in tgt cam, found flag, huber
    weight."""
    N, h, w, _ = xyz.shape
    cosn = _cos_deg(cfg.dense_normal_thres_deg, xyz.device)
    r = radius
    W = 2 * r + 1
    packed = torch.cat([xyz, nrm], dim=-1).reshape(N * h * w, 6)
    use_bf16 = cfg.assoc_dtype == "bf16"
    packed_s = packed.to(torch.bfloat16) if use_bf16 else packed
    sel_dy = torch.arange(0, W, stride, device=xyz.device)
    dx = torch.arange(W, device=xyz.device)

    i, src_p, src_ok, p_tgt, n_tgt_of_src, u, v = _project_pairs(
        poses, xyz, nrm, K, pair_ij, src_idx, src_valid, cfg)
    u = _to_int(u)
    v = _to_int(v)
    u0 = torch.clamp(u - r, 0, w - W)                   # (P,D)
    v0 = torch.clamp(v - r, 0, h - W)
    in_img = (u >= -r) & (u < w + r) & (v >= -r) & (v < h + r)
    P, D = u.shape
    rows = ((v0[..., None, None] + sel_dy[:, None]) * w
            + (u0[..., None, None] + dx[None, :]))    # (P,D,ndy,W)
    flat = (i[:, None, None, None] * (h * w) + rows).reshape(P, D, -1)
    B = packed_s[flat]                                  # (P,D,taps,6)
    tp, tn = B[..., :3], B[..., 3:]
    dd = tp - p_tgt[:, :, None, :]
    dist = torch.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
                      + dd[..., 2] * dd[..., 2])
    ns = n_tgt_of_src[:, :, None, :]
    dot = tn[..., 0] * ns[..., 0] + tn[..., 1] * ns[..., 1] \
        + tn[..., 2] * ns[..., 2]
    ok = ((tp[..., 2] > 0.1) & (dist <= cfg.dense_dist_thres)
          & (dot >= cosn) & in_img[..., None])
    score = torch.where(ok, (1.0 - dot) + dist / cfg.dense_dist_thres,
                        torch.inf)                      # (P,D,taps)
    best_s = torch.min(score, dim=-1).values
    k = torch.argmin(score, dim=-1)                     # (P,D)
    found = torch.isfinite(best_s) & src_ok
    if use_bf16:
        # re-fetch the selected candidate in f32 and recompute the gates:
        # only the argmin selection saw bf16 storage rounding
        best = packed[torch.gather(flat, 2, k[..., None])[..., 0]]
        best_p, best_n = best[..., :3], best[..., 3:]
        dist_f = torch.linalg.norm(best_p - p_tgt, dim=-1)
        dot_f = torch.sum(best_n * n_tgt_of_src, dim=-1)
        found = (found & (best_p[..., 2] > 0.1)
                 & (dist_f <= cfg.dense_dist_thres) & (dot_f >= cosn))
    else:
        best = torch.gather(B, 2, k[..., None, None].expand(-1, -1, 1, 6))
        best_p, best_n = best[:, :, 0, :3], best[:, :, 0, 3:]
    res0 = torch.sum((best_p - p_tgt) * best_n, dim=-1)
    return {"src_p": src_p, "tgt_p": best_p, "tgt_n": best_n,
            "found": found, "huber": _huber(res0, cfg.robust_delta)}


def _projective_associate(poses, xyz, nrm, K, pair_ij, src_idx, src_valid,
                          cfg: BAConfig):
    """Single-tap projective data association: project each src point into
    the tgt frame and take that pixel. Same gates and Huber weight as
    `_dense_associate`."""
    N, h, w, _ = xyz.shape
    cosn = _cos_deg(cfg.dense_normal_thres_deg, xyz.device)
    packed = torch.cat([xyz, nrm], dim=-1).reshape(N * h * w, 6)
    i, src_p, src_ok, p_tgt, n_tgt_of_src, u, v = _project_pairs(
        poses, xyz, nrm, K, pair_ij, src_idx, src_valid, cfg)
    in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    ui = torch.clamp(_to_int(u), 0, w - 1)
    vi = torch.clamp(_to_int(v), 0, h - 1)
    row = packed[i[:, None] * (h * w) + vi * w + ui]    # (P,D,6)
    best_p, best_n = row[..., :3], row[..., 3:]
    dist = torch.linalg.norm(best_p - p_tgt, dim=-1)
    dot = torch.sum(best_n * n_tgt_of_src, dim=-1)
    found = ((best_p[..., 2] > 0.1) & (dist <= cfg.dense_dist_thres)
             & (dot >= cosn) & in_img & src_ok)
    res0 = torch.sum((best_p - p_tgt) * best_n, dim=-1)
    return {"src_p": src_p, "tgt_p": best_p, "tgt_n": best_n,
            "found": found, "huber": _huber(res0, cfg.robust_delta)}


def _overwrite_rows(a, b, dst):
    """a[dst[k]] = b[k] for dst[k] < len(a); rows with dst >= len(a) are
    dropped (the JAX `.at[dst].set(..., mode="drop")`) — through a spare
    row, so no data-dependent shape (and no host sync) arises."""
    P = a.shape[0]
    ext = torch.cat([a, a[:1]], dim=0)
    ext.index_copy_(0, torch.clamp(dst.long(), max=P), b)
    return ext[:P]


def _pair_blocks(s, H, b, N):
    """Assemble J^T J (6N,6N) and J^T r (6N,) from per-pair row groups whose
    Jacobian is +a on frame i and -a on frame j: @s (P,N) = onehot(i) -
    onehot(j), @H (P,6,6) = sum a a^T, @b (P,6) = sum a r."""
    JtJ = torch.einsum("pa,pb,pkl->akbl", s, s, H).reshape(6 * N, 6 * N)
    Jtr = torch.einsum("pa,pk->ak", s, b).reshape(6 * N)
    return JtJ, Jtr


def bundle_adjust(poses0, K_down, xyz_down, nrm_down, pair_ij,
                  corr_i, corr_j, corr_pi, corr_pj, corr_valid,
                  update_flags, src_idx, src_valid,
                  cfg: BAConfig = BAConfig(), pair_valid=None,
                  pair_ij_w=None, pair_w_dst=None, grey_down=None):
    """Jointly refine frame poses.

    @poses0: (N,4,4) cam-in-model. @K_down: (3,3) intrinsics of the
    downsampled grids. @xyz_down/@nrm_down: (N,h,w,3) camera-space maps.
    @pair_ij: (P,2) ordered (tgt i, src j) frame-index pairs for the dense
    term. Sparse correspondences: @corr_i/@corr_j (C,) frame indices;
    @corr_pi/@corr_pj (C,3) points in the respective CAMERA frames;
    @corr_valid (C,). @update_flags: (N,) 1=optimize, 0=pinned.
    @src_idx/@src_valid: (N,D) per-frame valid-point pixel indices.
    @pair_ij_w/@pair_w_dst (hybrid entry mode): (Pw,2) pair subset to
    entry-associate with the wide window, and (Pw,) destination row of each
    in @pair_ij (>= P: dropped). @grey_down: (N,h,w) intensities for the
    photometric term. Returns refined (N,4,4) poses."""
    N = poses0.shape[0]
    dev = poses0.device
    flags = update_flags.float()
    if pair_valid is None:
        pair_valid = torch.ones(pair_ij.shape[0], device=dev)
    pin = flags.repeat_interleave(6)
    pi_, pj_ = pair_ij[:, 0].long(), pair_ij[:, 1].long()
    s_pair = (F.one_hot(pi_, N) - F.one_hot(pj_, N)).float()    # (P,N)
    ci, cj = corr_i.long(), corr_j.long()
    s_sp = math.sqrt(cfg.w_sparse) * corr_valid.float()         # (C,)
    eye3 = torch.eye(3, device=dev)

    use_color = cfg.w_dense_color > 0 and grey_down is not None
    if use_color:
        hg, wg = grey_down.shape[1], grey_down.shape[2]
        gd_flat = grey_down.reshape(N, -1)
        I_src_pair = torch.gather(gd_flat, 1, src_idx.long())[pj_]  # (P,D)
        I_tgt_pair = gd_flat[pi_]                                  # (P,hw)
        src_v_pair = src_valid[pj_].float()
        fxc, fyc = K_down[0, 0], K_down[1, 1]
        cxc, cyc = K_down[0, 2], K_down[1, 2]

    def normal_equations(poses, assoc):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        # sparse: T_i p_i - T_j p_j, Jacobian [I, -hat(w)] per side
        wi = torch.einsum("cij,cj->ci", R[ci], corr_pi) + t[ci]
        wj = torch.einsum("cij,cj->ci", R[cj], corr_pj) + t[cj]
        r_sp = (wi - wj) * s_sp[:, None]                          # (C,3)
        Ai = torch.cat([eye3.expand(len(ci), 3, 3), -hat(wi)], -1)
        Aj = torch.cat([eye3.expand(len(cj), 3, 3), -hat(wj)], -1)
        J_sp = (F.one_hot(ci, N).float()[:, None, :, None] * Ai[:, :, None]
                - F.one_hot(cj, N).float()[:, None, :, None]
                * Aj[:, :, None]) * s_sp[:, None, None, None]     # (C,3,N,6)
        J_sp = J_sp.reshape(-1, 6 * N)
        JtJ = J_sp.T @ J_sp
        Jtr = J_sp.T @ r_sp.reshape(-1)

        # dense point-to-plane in tgt cam: n . (p_tgt - T_i^-1 T_j p_src)
        Ri, Rj = R[pi_], R[pj_]
        ti, tj = t[pi_], t[pj_]
        Rrel = torch.einsum("pji,pjk->pik", Ri, Rj)
        trel = torch.einsum("pji,pj->pi", Ri, tj - ti)
        p_in_tgt = torch.einsum("pij,pmj->pmi", Rrel, assoc["src_p"]) \
            + trel[:, None, :]
        r_d = torch.sum((assoc["tgt_p"] - p_in_tgt) * assoc["tgt_n"], -1)
        w_d = (torch.sqrt(cfg.w_dense * assoc["huber"])
               * assoc["found"].float() * pair_valid[:, None])
        r_d = r_d * w_d                                           # (P,D)
        g = torch.einsum("pij,pmj->pmi", Rj, assoc["src_p"]) + tj[:, None]
        m = torch.einsum("pij,pmj->pmi", Ri, assoc["tgt_n"])
        a = torch.cat([m, torch.linalg.cross(g, m, dim=-1)], -1) \
            * w_d[..., None]                                      # (P,D,6)
        H = torch.einsum("pdk,pdl->pkl", a, a)
        b = torch.einsum("pdk,pd->pk", a, r_d)
        if use_color:
            # photometric: bilinear sample of the tgt grey at the projected
            # src point; its pose Jacobian is the bilinear image gradient
            # (the reference's dIdx/dIdy chain rule) through the projection
            z = torch.clamp(p_in_tgt[..., 2], min=1e-6)
            px, py = p_in_tgt[..., 0], p_in_tgt[..., 1]
            u = px / z * fxc + cxc
            v = py / z * fyc + cyc
            u0 = torch.floor(u)
            v0 = torch.floor(v)
            fu = u - u0
            fv = v - v0
            u0i = torch.clamp(_to_int(u0), 0, wg - 2)
            v0i = torch.clamp(_to_int(v0), 0, hg - 2)
            base = (v0i * wg + u0i).long()
            I00 = torch.gather(I_tgt_pair, 1, base)
            I01 = torch.gather(I_tgt_pair, 1, base + 1)
            I10 = torch.gather(I_tgt_pair, 1, base + wg)
            I11 = torch.gather(I_tgt_pair, 1, base + wg + 1)
            It = (I00 * (1 - fu) * (1 - fv) + I01 * fu * (1 - fv)
                  + I10 * (1 - fu) * fv + I11 * fu * fv)
            r_c = It - I_src_pair
            gate = (((u >= 0) & (u <= wg - 1) & (v >= 0) & (v <= hg - 1)
                     & (p_in_tgt[..., 2] > cfg.dense_depth_min)).float()
                    * assoc["found"].float() * src_v_pair)
            w_c = (torch.sqrt(cfg.w_dense_color
                              * _huber(r_c, cfg.robust_delta_color))
                   * gate * pair_valid[:, None])
            dIdu = (I01 - I00) * (1 - fv) + (I11 - I10) * fv
            dIdv = (I10 - I00) * (1 - fu) + (I11 - I01) * fu
            dIdp = torch.stack([dIdu * fxc / z, dIdv * fyc / z,
                                -(dIdu * fxc * px + dIdv * fyc * py)
                                / (z * z)], -1)
            q = torch.einsum("pij,pmj->pmi", Ri, dIdp)
            a_c = -torch.cat([q, torch.linalg.cross(g, q, dim=-1)], -1) \
                * w_c[..., None]
            H = H + torch.einsum("pdk,pdl->pkl", a_c, a_c)
            b = b + torch.einsum("pdk,pd->pk", a_c, r_c * w_c)
        JtJ_d, Jtr_d = _pair_blocks(s_pair, H, b, N)
        return JtJ + JtJ_d, Jtr + Jtr_d

    def outer(poses, assoc):
        JtJ, Jtr = normal_equations(poses, assoc)
        # pinned frames: zero their delta columns, identity rows
        JtJ = JtJ * pin[:, None] * pin[None, :] \
            + torch.diag(torch.where(pin > 0, cfg.damping, 1.0))
        Jtr = Jtr * pin
        delta = -torch.linalg.solve_ex(JtJ, Jtr[:, None])[0][:, 0]
        # max per-frame update norm (the reference's EvalGNConvergence)
        dmax = torch.max(torch.linalg.norm(
            delta.reshape(-1, 6) * flags[:, None], dim=-1))
        return _pose_update(poses, delta, flags), dmax

    args = (xyz_down, nrm_down, K_down)
    stride_first = max(1, cfg.assoc_stride_first)
    if cfg.assoc_entry_mode == "projective":
        assoc = _projective_associate(poses0, *args, pair_ij, src_idx,
                                      src_valid, cfg)
    elif cfg.assoc_entry_mode == "hybrid" and pair_ij_w is not None:
        # projective single tap for every pair, then the uncertain pairs'
        # rows overwritten by the wide windowed search
        assoc = _projective_associate(poses0, *args, pair_ij, src_idx,
                                      src_valid, cfg)
        w_assoc = _dense_associate(poses0, *args, pair_ij_w, src_idx,
                                   src_valid, cfg, cfg.assoc_radius,
                                   stride=stride_first)
        assoc = {k: _overwrite_rows(assoc[k], w_assoc[k], pair_w_dst)
                 for k in assoc}
    else:
        # "window", and "hybrid" without the caller's uncertain-pair
        # subset: the all-window entry pass
        assoc = _dense_associate(poses0, *args, pair_ij, src_idx, src_valid,
                                 cfg, cfg.assoc_radius, stride=stride_first)
    poses, dmax = outer(poses0, assoc)

    # reassociate while it < reassoc_iters, then the association freezes
    # (a static schedule: a Python `if` on the iteration index)
    active = dmax > cfg.early_out_delta if cfg.early_out_delta > 0 else None
    for it in range(1, cfg.n_outer):
        if it < cfg.reassoc_iters:
            if cfg.assoc_refine_mode == "projective":
                assoc = _projective_associate(poses, *args, pair_ij, src_idx,
                                              src_valid, cfg)
            else:
                assoc = _dense_associate(poses, *args, pair_ij, src_idx,
                                         src_valid, cfg,
                                         cfg.assoc_radius_refine)
        new_poses, dmax = outer(poses, assoc)
        if active is None:
            poses = new_poses
        else:
            # converged frames stop moving: identical to the JAX
            # while_loop's trip count, with no host round trip
            poses = torch.where(active, new_poses, poses)
            active = active & (dmax > cfg.early_out_delta)
    return poses


def bundle_adjust_pooled(pool_xyzs, pool_nrms, slots, slot_live, poses0, K,
                         pair_ij, corr_i, corr_j, corr_pi, corr_pj,
                         corr_valid, update_flags, src_idx, src_valid,
                         factor: int, cfg: BAConfig = BAConfig(),
                         pair_valid=None, pool_valids=None, nf_idx=None,
                         kf_slots=None, kf_poses=None, kf_window_idx=None,
                         covis_thres_cos=None, pre_decim: int = 1,
                         pair_ij_w=None, pair_w_dst=None, pool_greys=None):
    """bundle_adjust fed straight from the FramePool: slot gather, padded-
    slot zeroing and the /@factor downsample.

    @pool_xyzs/@pool_nrms: pool maps already decimated by @pre_decim (the
    half-res pyramid with pre_decim=2 for even factors); @factor is the
    total downscale relative to full res. @slots: (N,) pool slots;
    @slot_live: (N,) 1.0 for real frames, 0.0 for padding.

    With the admission args (@pool_valids, @nf_idx, @kf_slots (KF,),
    @kf_poses (KF,4,4), @kf_window_idx (KF,) index into the BA window or
    -1, @covis_thres_cos) it also returns the keyframe-admission
    covisibility of the new frame against every keyframe at the post-BA
    poses (ref checkAndAddKeyframe Bundler.cpp:263-323), at half
    resolution: returns (poses, covis) then, else poses."""
    from bundlesdf_tpu_torch.tracker.pool import covis_core

    assert factor % pre_decim == 0
    s = factor // pre_decim
    slots = slots.long()
    live = slot_live[:, None, None, None]
    xyz_d = (pool_xyzs[slots] * live)[:, ::s, ::s]
    nrm_d = (pool_nrms[slots] * live)[:, ::s, ::s]
    grey_d = None
    if pool_greys is not None and cfg.w_dense_color > 0:
        # intensity is antialiased down to the BA grid by iterated centered
        # [1,2,1]/4 steps (sample i stays on full pixel i*s)
        g = pool_greys[slots] * slot_live[:, None, None]
        ss = s
        assert ss & (ss - 1) == 0, f"grey stride {s} must be a power of 2"
        while ss > 1:
            gp = F.pad(g[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
            sm = (gp[:, :-2] + 2.0 * gp[:, 1:-1] + gp[:, 2:]) * 0.25
            sm = (sm[:, :, :-2] + 2.0 * sm[:, :, 1:-1] + sm[:, :, 2:]) * 0.25
            g = sm[:, ::2, ::2]
            ss //= 2
        grey_d = g
    K_d = K.float().clone()
    K_d[:2] = K_d[:2] * (1.0 / factor)
    poses = bundle_adjust(poses0, K_d, xyz_d, nrm_d, pair_ij, corr_i,
                          corr_j, corr_pi, corr_pj, corr_valid,
                          update_flags, src_idx, src_valid, cfg,
                          pair_valid=pair_valid, pair_ij_w=pair_ij_w,
                          pair_w_dst=pair_w_dst, grey_down=grey_d)
    if nf_idx is None:
        return poses
    assert pre_decim <= 2
    c = 2 // pre_decim
    in_window = kf_window_idx >= 0
    kf_pose_eff = torch.where(in_window[:, None, None],
                              poses[torch.clamp(kf_window_idx.long(), min=0)],
                              kf_poses)
    Ts = _inv(kf_pose_eff) @ poses[nf_idx]   # nf cam -> kf cam
    src_slots = torch.zeros_like(kf_slots) + slots[nf_idx].to(kf_slots.dtype)
    covis = covis_core(pool_xyzs[:, ::c, ::c], pool_nrms[:, ::c, ::c],
                       pool_valids[:, ::c, ::c], src_slots.long(), Ts,
                       covis_thres_cos)
    return poses, covis


def downsample_maps(xyz, nrm, K, factor: int):
    """Stride-subsample xyz/normal maps + intrinsics for the dense term
    (replaces `CUDACache` construction, `LossGPU.cpp:93-99`)."""
    K_d = torch.as_tensor(K).float().clone()
    K_d[:2] = K_d[:2] * (1.0 / factor)
    return (xyz[..., ::factor, ::factor, :], nrm[..., ::factor, ::factor, :],
            K_d)
