"""Classical weight-free matcher: ORB keypoints + mutual nearest neighbor.

Port of `bundlesdf_tpu/matcher/classical.py`. Detection runs on the
matcher's device: `detect_features` crops the frame to its mask and hands
the crop to `matcher/orb.py`, the counterpart of the cv2 ORB the JAX
package calls (on the card, on a stream of its own, so it overlaps the
tracker's queued work). The per-frame result is cached on the device as a
+/-1 bit expansion of the descriptors, and every pair of a call is matched
at once by `orb_match_core`: hamming distance = (nbits - bitsA @ bitsB^T)
/ 2, an exact float32 matmul (TF32 is off, see
`bundlesdf_tpu_torch/__init__.py`), then the two-way ratio test and the
mutual check.

`predict(rgbAs, rgbBs)` is the LoFTR-shaped contract of the JAX
package's `OrbMatcher.predict`: ORB on each whole image (no mask, crop or
zoom), every pair of the call matched by one `orb_match_core` call, one
host pull.

Detection is replaceable: `OrbMatcher(detector=fn)` takes `fn(frame) ->
(uv (n,2) float32, des (n,32) uint8)`, numpy or tensors, already capped at
`FEAT_CAP`, in full-res pixel coords, in place of `detect_features`; the
replay runs feed stored features through it. `predict` hands it each
image as a frame with no mask (`fg_mask` None), to be detected whole.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from perfbench.reference.frozen import resolve_device
from perfbench.reference.frozen.matcher import orb
from perfbench.reference.frozen.utils.common import resize_nearest
from perfbench.reference.frozen.utils.transfer import HostPull


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
        @device: where detection, the descriptor cache and the matching
        live. @detector: optional replacement of `detect_features`."""
        self.n_features = int(n_features)
        self.ratio = ratio
        self.ratio_loose = ratio_loose
        self.min_strict = int(min_strict)
        self.device = resolve_device(device)
        self.detector = detector
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._cache: dict[int, tuple] = {}
        if feat_cap is not None:
            self.FEAT_CAP = int(feat_cap)

    # -- detection ----------------------------------------------------------
    def detect_features(self, frame):
        """ORB (`matcher/orb.py`) on the mask bbox crop zoomed to
        DETECT_SIZE (the reference's processImagePair resizes crops to
        400x400; here it is per frame, with no rotation warp, since
        oriented BRIEF is in-plane rotation invariant). Returns (uv (n,2)
        float32 full-res, des (n,32) uint8), tensors on the matcher's
        device, the FEAT_CAP strongest responses. One host sync: the
        keypoint count."""
        dev = self.device
        mask = np.asarray(frame.fg_mask) > 0
        vs, us = np.nonzero(mask)
        if len(vs) == 0:
            return (torch.zeros((0, 2), dtype=torch.float32, device=dev),
                    torch.zeros((0, 32), dtype=torch.uint8, device=dev))
        m = 10
        v0, v1 = max(vs.min() - m, 0), min(vs.max() + m + 1, mask.shape[0])
        u0, u1 = max(us.min() - m, 0), min(us.max() + m + 1, mask.shape[1])
        cmask = mask[v0:v1, u0:u1].astype(np.uint8)
        gray = orb.rgb_to_gray(orb.to_device(
            np.asarray(frame.color)[v0:v1, u0:u1], dev))
        zoom = self.DETECT_SIZE / max(cmask.shape)
        if abs(zoom - 1.0) > 0.05:
            size = (max(int(round(cmask.shape[1] * zoom)), 8),
                    max(int(round(cmask.shape[0] * zoom)), 8))
            gray = orb.resize_linear(gray, size)
            cmask = resize_nearest(cmask, size)
            zoom_uv = (size[0] / (u1 - u0), size[1] / (v1 - v0))
        else:
            zoom_uv = (1.0, 1.0)
        out = orb.detect_and_compute(gray, orb.to_device(cmask, dev),
                                     self.n_features)
        pt = out["pt"].double()
        uv = torch.stack([pt[:, 0] / zoom_uv[0] + float(u0),
                          pt[:, 1] / zoom_uv[1] + float(v0)], 1)
        uv, des = uv.to(torch.float32), out["des"]
        if len(uv) > self.FEAT_CAP:
            order = torch.argsort(-out["response"], stable=True)
            order = order[:self.FEAT_CAP]
            uv, des = uv[order], des[order]
        return uv, des

    # -- per-frame device cache -------------------------------------------
    def _frame_feats(self, frame):
        """(uv (n,2) float32, des (n,32) uint8 or None, bits (FEAT_CAP,
        nbits) int8 +/-1, uv (FEAT_CAP, 2) float32), tensors on the
        device, cached by frame id. On the card detection runs on the
        matcher's stream, which the current stream then waits for."""
        hit = self._cache.get(frame.id)
        if hit is not None:
            return hit
        main = (torch.cuda.current_stream(self.device)
                if self._stream is not None else None)
        if main is not None:
            with torch.cuda.stream(self._stream):
                entry = self._build_entry(frame)
            main.wait_stream(self._stream)
            for t in entry:
                if t is not None:
                    t.record_stream(main)
        else:
            entry = self._build_entry(frame)
        if len(self._cache) >= self.CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[frame.id] = entry
        return entry

    def _build_entry(self, frame):
        uv, des = (self.detector(frame) if self.detector is not None
                   else self.detect_features(frame))
        uv = torch.as_tensor(uv, dtype=torch.float32,
                             device=self.device).reshape(-1, 2)
        n = len(uv)
        if n == 0:
            return (uv, None, None, None)
        des = torch.as_tensor(des, dtype=torch.uint8, device=self.device)
        return (uv, des, _pm1_bits(des, self.FEAT_CAP),
                _padded(uv, self.FEAT_CAP))

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
            uvA, uvB = (feats[i][0][0].cpu().numpy(),
                        feats[i][1][0].cpu().numpy())
            sel = np.nonzero(accept[k, :len(uvA)])[0]
            j = j_best[k, sel]
            conf = 1.0 / (1.0 + dist[k, sel] / 64.0)
            out[i] = np.concatenate([uvA[sel], uvB[j], conf[:, None]],
                                    axis=1).astype(np.float32)
        return out

    # -- the LoFTR-shaped contract ------------------------------------------
    def _detect_image(self, img):
        """(uv (n,2) float32, des (n,32) uint8), tensors on the matcher's
        device, of a whole (H,W[,3]) uint8 image (numpy or tensor): ORB
        with no mask, crop, zoom or cap, as the JAX package's `predict`
        detects, or the injected detector on a frame with no mask."""
        if self.detector is not None:
            uv, des = self.detector(SimpleNamespace(id=None, color=img,
                                                    fg_mask=None))
        else:
            gray = (img.to(self.device) if isinstance(img, torch.Tensor)
                    else orb.to_device(img, self.device))
            if gray.ndim == 3:
                gray = orb.rgb_to_gray(gray)
            out = orb.detect_and_compute(gray, None, self.n_features)
            uv, des = out["pt"], out["des"]
        return (torch.as_tensor(uv, dtype=torch.float32,
                                device=self.device).reshape(-1, 2),
                torch.as_tensor(des, dtype=torch.uint8,
                                device=self.device).reshape(-1, 32))

    def predict(self, rgbAs, rgbBs):
        """@rgbAs/@rgbBs: sequences of (H,W[,3]) uint8 images, numpy or
        tensors (a (B,H,W) uint8 tensor is a sequence of B grey images).
        Returns per pair a float32 (N,5) [uA,vA,uB,vB,1/(1+d/64)], d the
        hamming distance, rows in A's keypoint order; a pair with fewer
        than 2 keypoints on either side gives (0,5). Every pair is matched
        in one `orb_match_core` call, and the results come back in one
        host pull."""
        feats = [(self._detect_image(a), self._detect_image(b))
                 for a, b in zip(rgbAs, rgbBs)]
        out = [np.zeros((0, 5), np.float32)] * len(feats)
        live = [i for i, ((uvA, _), (uvB, _)) in enumerate(feats)
                if len(uvA) >= 2 and len(uvB) >= 2]
        if not live:
            return out
        F = max(len(feats[i][s][0]) for i in live for s in (0, 1))
        side = [[feats[i][s] for i in live] for s in (0, 1)]
        res = orb_match_core(
            *(torch.stack([_pm1_bits(des, F) for _, des in sd])
              for sd in side),
            *(torch.tensor([len(uv) for uv, _ in sd], device=self.device)
              for sd in side),
            float(self.ratio), 8 * 32, float(self.ratio_loose),
            int(self.min_strict))
        host = HostPull({
            "j": res["j"], "ok": res["ok"], "dist": res["dist"],
            "uvA": torch.stack([_padded(uv, F) for uv, _ in side[0]]),
            "uvB": torch.stack([_padded(uv, F) for uv, _ in side[1]])}).get()
        for k, i in enumerate(live):
            sel = np.nonzero(host["ok"][k])[0]
            conf = 1.0 / (1.0 + host["dist"][k, sel] / 64.0)
            out[i] = np.concatenate(
                [host["uvA"][k, sel], host["uvB"][k, host["j"][k, sel]],
                 conf[:, None]], axis=1).astype(np.float32)
        return out


def _pm1_bits(des, cap):
    """(cap, 256) int8: the bits of (n,32) uint8 descriptors as +/-1, in
    np.unpackbits order (most significant first), rows from n on 0."""
    shift = torch.arange(7, -1, -1, device=des.device, dtype=torch.uint8)
    bits = ((des[:, :, None] >> shift) & 1).reshape(len(des), -1)
    return _padded(bits.to(torch.int8) * 2 - 1, cap)


def _padded(t, cap):
    """@t (n, ...) with zero rows appended up to @cap rows."""
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:len(t)] = t
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
