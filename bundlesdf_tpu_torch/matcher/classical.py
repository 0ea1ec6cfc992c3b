"""Classical weight-free matcher: ORB keypoints + mutual nearest neighbor.

Port of `bundlesdf_tpu/matcher/classical.py`. ORB detection stays on the
host (cv2, imported only inside `detect_features`); the per-frame result
is cached on the device as a +/-1 bit expansion of the descriptors, and
every pair of a call is matched at once by `orb_match_core`: hamming
distance = (nbits - bitsA @ bitsB^T) / 2, an exact float32 matmul (TF32
is off, see `bundlesdf_tpu_torch/__init__.py`), then the two-way ratio
test and the mutual check.

The host detection is replaceable: `OrbMatcher(detector=fn)` takes
`fn(frame) -> (uv (n,2) float32, des (n,32) uint8)` — already capped at
`FEAT_CAP`, in full-res pixel coords — in place of cv2 (the GPU smoke run
feeds features detected elsewhere through it).
"""
from __future__ import annotations

import numpy as np
import torch

from bundlesdf_tpu_torch import resolve_device


class OrbMatcher:
    # per-frame feature cache capacity (keyframes + window)
    CACHE_CAP = 256
    FEAT_CAP = 2048    # padded descriptor count per frame (device shapes)
    DETECT_SIZE = 400  # canonical crop size for detection (ref resize)

    def __init__(self, n_features: int = 2000, ratio: float = 0.75,
                 ratio_loose: float = 0.85, min_strict: int = 0,
                 feat_cap: int | None = None, device="cuda", detector=None):
        """@ratio: mutual ratio test threshold; @ratio_loose/@min_strict:
        opt-in two-tier fallback (min_strict > 0) — pairs whose strict-gate
        match count falls below min_strict use ratio_loose (see the JAX
        package's docstring for the measurements behind the defaults).
        @device: where the descriptor cache and the matching live.
        @detector: optional replacement of the cv2 host detection."""
        self.n_features = int(n_features)
        self.ratio = ratio
        self.ratio_loose = ratio_loose
        self.min_strict = int(min_strict)
        self.device = resolve_device(device)
        self.detector = detector
        self._orb = None
        self._cache: dict[int, tuple] = {}
        if feat_cap is not None:
            self.FEAT_CAP = int(feat_cap)

    # -- host detection ---------------------------------------------------
    def detect_features(self, frame):
        """cv2 ORB on the mask bbox crop zoomed to DETECT_SIZE (the
        reference's processImagePair resizes crops to 400x400; here it is
        per frame, with no rotation warp, since oriented BRIEF is in-plane
        rotation invariant). Returns (uv (n,2) float32 full-res, des
        (n,32) uint8), the FEAT_CAP strongest responses."""
        import cv2

        if self._orb is None:
            self._orb = cv2.ORB_create(nfeatures=self.n_features,
                                       fastThreshold=5)
        empty = (np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8))
        gray = cv2.cvtColor(np.asarray(frame.color), cv2.COLOR_RGB2GRAY)
        mask = (np.asarray(frame.fg_mask) > 0).astype(np.uint8)
        vs, us = np.nonzero(mask)
        if len(vs) == 0:
            return empty
        m = 10
        v0, v1 = max(vs.min() - m, 0), min(vs.max() + m + 1, mask.shape[0])
        u0, u1 = max(us.min() - m, 0), min(us.max() + m + 1, mask.shape[1])
        crop = gray[v0:v1, u0:u1]
        cmask = mask[v0:v1, u0:u1]
        zoom = self.DETECT_SIZE / max(crop.shape)
        if abs(zoom - 1.0) > 0.05:
            size = (max(int(round(crop.shape[1] * zoom)), 8),
                    max(int(round(crop.shape[0] * zoom)), 8))
            crop = cv2.resize(crop, size, interpolation=cv2.INTER_LINEAR)
            cmask = cv2.resize(cmask, size, interpolation=cv2.INTER_NEAREST)
            zoom_uv = (size[0] / (u1 - u0), size[1] / (v1 - v0))
        else:
            zoom_uv = (1.0, 1.0)
        kps, des = self._orb.detectAndCompute(crop, cmask)
        if des is None or len(kps) == 0:
            return empty
        uv = (np.array([k.pt for k in kps], np.float32) / zoom_uv
              + (u0, v0)).astype(np.float32)
        if len(uv) > self.FEAT_CAP:
            order = np.argsort([-k.response for k in kps])[:self.FEAT_CAP]
            uv, des = uv[order], des[order]
        return uv, des

    # -- per-frame device cache -------------------------------------------
    def _frame_feats(self, frame):
        """(uv host (n,2), des host (n,32) or None, bits (FEAT_CAP, nbits)
        int8 +/-1 on the device, uv (FEAT_CAP, 2) float32 on the device),
        cached by frame id."""
        hit = self._cache.get(frame.id)
        if hit is not None:
            return hit
        uv, des = (self.detector(frame) if self.detector is not None
                   else self.detect_features(frame))
        uv = np.asarray(uv, np.float32).reshape(-1, 2)
        if len(uv) == 0:
            entry = (uv, None, None, None)
        else:
            des = np.asarray(des, np.uint8)
            bits = np.unpackbits(des, axis=1).astype(np.int8) * 2 - 1
            bits_p = np.zeros((self.FEAT_CAP, bits.shape[1]), np.int8)
            bits_p[:len(bits)] = bits
            uv_p = np.zeros((self.FEAT_CAP, 2), np.float32)
            uv_p[:len(uv)] = uv
            entry = (uv, des, torch.from_numpy(bits_p).to(self.device),
                     torch.from_numpy(uv_p).to(self.device))
        if len(self._cache) >= self.CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[frame.id] = entry
        return entry

    def match_frames(self, frame_pairs):
        """@frame_pairs: [(fA, fB)] tracker Frame objects. Returns per-pair
        (N,5) [uA,vA,uB,vB,conf] in FULL-RES pixel coords; every pair is
        matched in one batched `orb_match_core` call."""
        feats = [(self._frame_feats(fA), self._frame_feats(fB))
                 for fA, fB in frame_pairs]
        live = [i for i, ((_, dA, *_), (_, dB, *_)) in enumerate(feats)
                if dA is not None and dB is not None]
        out = [np.zeros((0, 5), np.float32)] * len(frame_pairs)
        if not live:
            return out
        nbits = feats[live[0]][0][2].shape[1]
        bA = torch.stack([feats[i][0][2] for i in live])
        bB = torch.stack([feats[i][1][2] for i in live])
        nA = torch.tensor([len(feats[i][0][0]) for i in live],
                          device=self.device)
        nB = torch.tensor([len(feats[i][1][0]) for i in live],
                          device=self.device)
        res = orb_match_core(bA, bB, nA, nB, float(self.ratio), nbits,
                             float(self.ratio_loose), int(self.min_strict))
        j_best, accept, dist = (res["j"].cpu().numpy(), res["ok"].cpu().numpy(),
                                res["dist"].cpu().numpy())
        for k, i in enumerate(live):
            (uvA, *_), (uvB, *_) = feats[i]
            sel = np.nonzero(accept[k, :len(uvA)])[0]
            j = j_best[k, sel]
            conf = 1.0 / (1.0 + dist[k, sel] / 64.0)
            out[i] = np.concatenate([uvA[sel], uvB[j], conf[:, None]],
                                    axis=1).astype(np.float32)
        return out


def orb_match_core(bitsA, bitsB, nA, nB, ratio, nbits, ratio_loose=None,
                   min_strict: int = 0):
    """Batched mutual-ratio hamming matching.
    @bitsA/@bitsB: (P,F,nbits) +/-1 int8 (padded rows masked by @nA/@nB).
    Returns {"j": (P,F) best B index per A row, "ok": (P,F) accepted,
    "dist": (P,F) float32 best hamming distance}.

    Ratio test (best < ratio * second-best) in both directions + mutual-NN,
    the host `_match_feats` semantics of the JAX package; with
    @min_strict > 0 a pair whose strict-gate count is below it uses
    @ratio_loose instead. Ties resolve to the lowest index (argmin)."""
    if ratio_loose is None or ratio_loose <= ratio or min_strict <= 0:
        ratio_loose = ratio
        min_strict = 0
    P, F, _ = bitsA.shape
    dev = bitsA.device
    sim = torch.bmm(bitsA.float(), bitsB.float().transpose(1, 2))  # (P,F,F)
    dist = (nbits - sim) * 0.5
    iota = torch.arange(F, device=dev)
    rowmask = iota[None, :] < nA[:, None]                         # (P,F)
    colmask = iota[None, :] < nB[:, None]
    big = 512.0
    d = torch.where(colmask[:, None, :] & rowmask[:, :, None], dist, big)
    # row direction: best + runner-up
    j1 = torch.argmin(d, dim=2)
    d1 = torch.min(d, dim=2).values
    d2 = torch.min(torch.where(iota[None, None, :] == j1[..., None], big, d),
                   dim=2).values
    # column direction
    i1 = torch.argmin(d, dim=1)
    c1 = torch.min(d, dim=1).values
    c2 = torch.min(torch.where(iota[None, :, None] == i1[:, None, :], big, d),
                   dim=1).values
    # with < 2 candidates on either side the runner-up distance is the
    # sentinel and the ratio test is vacuous; the host path (knnMatch
    # len==2 filter) rejects such pairs
    two = ((nA >= 2) & (nB >= 2))[:, None]
    mutual = torch.gather(i1, 1, j1) == iota[None, :]

    def gate(r):
        row_ok = (d1 < r * d2) & rowmask & (d1 < big)
        col_ok = (c1 < r * c2) & colmask & (c1 < big)
        return row_ok & mutual & torch.gather(col_ok, 1, j1) & two

    ok = gate(ratio)
    if min_strict > 0:
        enough = ok.sum(1, keepdim=True) >= min_strict
        ok = torch.where(enough, ok, gate(ratio_loose))
    return {"j": j1, "ok": ok, "dist": d1}
