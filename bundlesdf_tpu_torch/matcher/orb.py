"""ORB detection as torch ops: the counterpart of
`cv2.ORB_create(nfeatures=2000, fastThreshold=5).detectAndCompute(gray,
mask)` with cv2's other defaults (scale 1.2, 8 levels, edge threshold 31,
patch 31, WTA_K 2, Harris score), on the device of its input.

Each stage repeats OpenCV's arithmetic, so the keypoints and descriptors
are cv2's (held stage by stage against cv2 in `tests/test_torch_orb.py`):

- `rgb_to_gray`: `COLOR_RGB2GRAY`, 15-bit fixed point;
- `resize_linear`: `INTER_LINEAR` on uint8, 11-bit weights rounded as its
  vector path rounds (the matcher's crop zoom);
- `resize_linear_exact`: `INTER_LINEAR_EXACT`, 8-bit weights; level i of
  the pyramid is level i-1 resized to round(size / 1.2^i), and the mask's
  level is the previous mask level resized the same way, nonzero kept;
- FAST-9/16 with its corner score and 3x3 non-max suppression;
- keypoints 31 px inside a level and on the mask, then the 2 x quota best
  FAST scores, then the quota best Harris responses (7x7 block, k 0.04);
  both cuts keep every tie at the boundary, as `KeyPointsFilter::
  retainBest` does, so the kept set does not depend on an order;
- `ic_angles`: the intensity centroid over the radius-15 disc, `fast_atan2`;
- `rbrief`: the 256 tests of `PATTERN` rotated by the keypoint's angle,
  rounded half to even, read from the level blurred 7x7 with sigma 2 in
  float32 (`gaussian_blur7`, the path of ORB's in-place blur of a level).

All levels sit in one stack, each padded by 32 px of BORDER_REFLECT_101
as in cv2's pyramid buffer, so each stage is one batched op over the
stack. The one host sync is the `nonzero` that counts the keypoints kept.
Imports neither cv2 nor jax.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from bundlesdf_tpu_torch.utils.profiling import span

N_LEVELS = 8
SCALE_FACTOR = 1.2
EDGE_THRESHOLD = 31
PATCH_SIZE = 31
HARRIS_BLOCK = 7
HARRIS_K = 0.04
# cv2's pyramid border: max(edge 31, ceil(15 * sqrt 2) = 22, 9 // 2) + 1
BORDER = 32

# OpenCV's `bit_pattern_31_`: test t compares the blurred level at
# (x0, y0) and (x1, y1) = PATTERN[t], bit t % 8 of byte t // 8 set when
# the first is darker. Recovered by probing cv2's `ORB.compute` with one
# keypoint at angle 0 on step images: a step swept across the patch in x
# sets bit t over an interval of step positions whose ends give x0 and x1
# (a rising and a falling step tell their order), a sweep in y gives the
# y's, and diagonal steps resolve the tests whose two x's (or y's) are
# equal. Held against `orb.compute` on random keypoints and angles in
# `tests/test_torch_orb.py`.
PATTERN = (
    8, -3, 9, 5,  4, 2, 7, -12,  -11, 9, -8, 2,  7, -12, 12, -13,
    2, -13, 2, 12,  1, -7, 1, 6,  -2, -10, -2, -4,  -13, -13, -11, -8,
    -13, -3, -12, -9,  10, 4, 11, 9,  -13, -8, -8, -9,  -11, 7, -9, 12,
    7, 7, 12, 6,  -4, -5, -3, 0,  -13, 2, -12, -3,  -9, 0, -7, 5,
    12, -6, 12, -1,  -3, 6, -2, 12,  -6, -13, -4, -8,  11, -13, 12, -8,
    4, 7, 5, 1,  5, -3, 10, -3,  3, -7, 6, 12,  -8, -7, -6, -2,
    -2, 11, -1, -10,  -13, 12, -8, 10,  -7, 3, -5, -3,  -4, 2, -3, 7,
    -10, -12, -6, 11,  5, -12, 6, -7,  5, -6, 7, -1,  1, 0, 4, -5,
    9, 11, 11, -13,  4, 7, 4, 12,  2, -1, 4, 4,  -4, -12, -2, 7,
    -8, -5, -7, -10,  4, 11, 9, 12,  0, -8, 1, -13,  -13, -2, -8, 2,
    -3, -2, -2, 3,  -6, 9, -4, -9,  8, 12, 10, 7,  0, 9, 1, 3,
    7, -5, 11, -10,  -13, -6, -11, 0,  10, 7, 12, 1,  -6, -3, -6, 12,
    10, -9, 12, -4,  -13, 8, -8, -12,  -13, 0, -8, -4,  3, 3, 7, 8,
    5, 7, 10, -7,  -1, 7, 1, -12,  3, -10, 5, 6,  2, -4, 3, -10,
    -13, 0, -13, 5,  -13, -7, -12, 12,  -13, 3, -11, 8,  -7, 12, -4, 7,
    6, -10, 12, 8,  -9, -1, -7, -6,  -2, -5, 0, 12,  -12, 5, -7, 5,
    3, -10, 8, -13,  -7, -7, -4, 5,  -3, -2, -1, -7,  2, 9, 5, -11,
    -11, -13, -5, -13,  -1, 6, 0, -1,  5, -3, 5, 2,  -4, -13, -4, 12,
    -9, -6, -9, 6,  -12, -10, -8, -4,  10, 2, 12, -3,  7, 12, 12, 12,
    -7, -13, -6, 5,  -4, 9, -3, 4,  7, -1, 12, 2,  -7, 6, -5, 1,
    -13, 11, -12, 5,  -3, 7, -2, -6,  7, -8, 12, -7,  -13, -7, -11, -12,
    1, -3, 12, 12,  2, -6, 3, 0,  -4, 3, -2, -13,  -1, -13, 1, 9,
    7, 1, 8, -6,  1, -1, 3, 12,  9, 1, 12, 6,  -1, -9, -1, 3,
    -13, -13, -10, 5,  7, 7, 10, 12,  12, -5, 12, 9,  6, 3, 7, 11,
    5, -13, 6, 10,  2, -12, 2, 3,  3, 8, 4, -6,  2, 6, 12, -13,
    9, -12, 10, 3,  -8, 4, -7, 9,  -11, 12, -4, -6,  1, 12, 2, -8,
    6, -9, 7, -4,  2, 3, 3, -2,  6, 3, 11, 0,  3, -3, 8, -8,
    7, 8, 9, 3,  -11, -5, -6, -4,  -10, 11, -5, 10,  -5, -8, -3, 12,
    -10, 5, -9, 0,  8, -1, 12, -6,  4, -6, 6, -11,  -10, 12, -8, 7,
    4, -2, 6, 7,  -2, 0, -2, 12,  -5, -8, -5, 2,  7, -6, 10, 12,
    -9, -13, -8, -8,  -5, -13, -5, -2,  8, -8, 9, -13,  -9, -11, -9, 0,
    1, -8, 1, -2,  7, -4, 9, 1,  -2, 1, -1, -4,  11, -6, 12, -11,
    -12, -9, -6, 4,  3, 7, 7, 12,  5, 5, 10, 8,  0, -4, 2, 8,
    -9, 12, -5, -13,  0, 7, 2, 12,  -1, 2, 1, 7,  5, 11, 7, -9,
    3, 5, 6, -8,  -13, -4, -8, 9,  -5, 9, -3, -3,  -4, -7, -3, -12,
    6, 5, 8, 0,  -7, 6, -6, 12,  -13, 6, -5, -2,  1, -10, 3, 10,
    4, 1, 8, -4,  -2, -2, 2, -13,  2, -12, 12, 12,  -2, -13, 0, -6,
    4, 1, 9, 3,  -6, -10, -3, -5,  -3, -13, -1, 1,  7, 5, 12, -11,
    4, -2, 5, -7,  -13, 9, -9, -5,  7, 1, 8, 6,  7, -8, 7, 6,
    -7, -4, -7, 1,  -8, 11, -7, -8,  -13, 6, -12, -8,  2, 4, 3, 9,
    10, -5, 12, 3,  -6, -5, -6, 7,  8, -3, 9, -8,  2, -12, 2, 8,
    -11, -2, -10, 3,  -12, -13, -7, -9,  -11, 0, -10, -5,  5, -3, 11, 8,
    -2, -13, -1, 12,  -1, -8, 0, 9,  -13, -11, -12, -5,  -10, -2, -10, 11,
    -3, 9, -2, -13,  2, -3, 3, 2,  -9, -13, -4, 0,  -4, 6, -3, -10,
    -4, 12, -2, -7,  -6, -11, -4, 9,  6, -3, 6, 11,  -13, 11, -5, 5,
    11, 11, 12, 6,  7, -5, 12, -2,  -1, 12, 0, 7,  -4, -8, -3, -2,
    -7, 1, -6, 7,  -13, -12, -8, -13,  -7, -2, -6, -8,  -8, 5, -6, -9,
    -5, -1, -4, 5,  -13, 7, -8, 10,  1, 5, 5, -13,  1, 0, 10, -13,
    9, 12, 10, -1,  5, -8, 10, -9,  -1, 11, 1, -13,  -9, -3, -6, 2,
    -1, -10, 1, 12,  -13, 1, -8, -10,  8, -11, 10, -6,  2, -13, 3, -6,
    7, -13, 12, -9,  -10, -10, -5, -7,  -10, -8, -8, -13,  4, -6, 8, 5,
    3, 12, 8, -13,  -4, 2, -3, -3,  5, -13, 10, -12,  4, -13, 5, -1,
    -9, 9, -4, 3,  0, 3, 3, -9,  -12, 1, -6, 1,  3, 2, 4, -8,
    -10, -10, -10, 9,  8, -13, 12, 12,  -8, -12, -6, -5,  2, 2, 3, 7,
    10, 6, 11, -8,  6, 8, 8, -12,  -7, 10, -6, 5,  -3, -9, -3, 9,
    -1, -13, -1, 5,  -3, -7, -3, 4,  -8, -2, -8, 3,  4, 2, 12, 12,
    2, -5, 3, 11,  6, -9, 11, -13,  3, -1, 7, 12,  11, -1, 12, 4,
    -3, 0, -3, 6,  4, -11, 4, 12,  2, -4, 2, 1,  -10, -6, -8, 1,
    -13, 7, -11, 1,  -13, 12, -11, -13,  6, 0, 11, -13,  0, -1, 1, 4,
    -13, 3, -9, -2,  -9, 8, -6, -3,  -13, -6, -8, -2,  5, -9, 8, 10,
    2, 7, 3, -9,  -1, -6, -1, -1,  9, 5, 11, -2,  11, -3, 12, -8,
    3, 0, 3, 5,  -1, 4, 0, 10,  3, -6, 4, 5,  -13, 0, -10, 5,
    5, 8, 12, 11,  8, 9, 9, -6,  7, -4, 8, -12,  -10, 4, -10, 9,
    7, 3, 12, 4,  9, -7, 10, -2,  7, 0, 12, -2,  -1, -6, 0, -11,
)

_FAST_RING = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
              (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
              (-3, 1), (-2, 2), (-1, 3))     # (dx, dy) in circle order


def to_device(array, device, dtype=None):
    """Host values -> tensor on @device without a host sync: pinned
    staging and an asynchronous copy on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(array, dtype)))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def level_scales(n_levels=N_LEVELS):
    """cv2's `getScale`: float32(f ** level), f the float32 scale factor
    that `ORB_create` takes, raised in double."""
    f = float(np.float32(SCALE_FACTOR))
    return [float(np.float32(f ** lev)) for lev in range(n_levels)]


def level_sizes(h, w, n_levels=N_LEVELS):
    """[(h_l, w_l)]: cvRound(size / scale) in float32, half to even."""
    out = []
    for s in level_scales(n_levels):
        s = np.float32(s)
        out.append((int(np.rint(np.float32(h) / s)),
                    int(np.rint(np.float32(w) / s))))
    return out


def level_quotas(n_features):
    """Features per level, a geometric series in float32 as cv2 sums it:
    434, 362, 302, 251, 209, 175, 145, 122 for 2000 at 1.2."""
    factor = np.float32(1.0 / float(np.float32(SCALE_FACTOR)))
    want = (np.float32(n_features) * (np.float32(1) - factor)
            / (np.float32(1) - np.float32(float(factor) ** N_LEVELS)))
    out = []
    for _ in range(N_LEVELS - 1):
        out.append(int(np.rint(want)))
        want = np.float32(want * factor)
    out.append(max(n_features - sum(out), 0))
    return out


def rgb_to_gray(rgb):
    """cv2.cvtColor(rgb, COLOR_RGB2GRAY) on uint8 (..., 3)."""
    c = rgb.to(torch.int32)
    g = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
         + (1 << 14)) >> 15
    return g.to(torch.uint8)


def _linear_fraction(src, dst, device):
    """INTER_LINEAR's source index and float32 fraction per destination
    pixel: fx = float32((d + 0.5) * (1 / (dst / src)) - 0.5)."""
    scale = 1.0 / (dst / src)
    f = ((torch.arange(dst, dtype=torch.float64, device=device) + 0.5)
         * scale - 0.5).to(torch.float32)
    s = torch.floor(f)
    return s.to(torch.int64), f - s


def _weights(f):
    """round(2048 * (1 - f)), round(2048 * f) in float32, int32."""
    return (((1 - f) * 2048).round().to(torch.int32),
            (f * 2048).round().to(torch.int32))


@functools.lru_cache(maxsize=512)
def _linear_x(src, dst, device):
    """INTER_LINEAR's horizontal taps: destinations left of the first or
    right of the last source centre take that pixel whole."""
    s, f = _linear_fraction(src, dst, device)
    edge = (s < 0) | (s >= src - 1)
    f = torch.where(edge, torch.zeros_like(f), f)
    s = s.clamp(0, src - 1)
    return (s, (s + 1).clamp(max=src - 1)) + _weights(f)


@functools.lru_cache(maxsize=512)
def _linear_y(src, dst, device):
    """INTER_LINEAR's vertical taps: rows clamped, weights not."""
    s, f = _linear_fraction(src, dst, device)
    return (s.clamp(0, src - 1), (s + 1).clamp(0, src - 1)) + _weights(f)


def resize_linear(img, size):
    """cv2.resize(img, size=(w, h), interpolation=INTER_LINEAR) on a
    uint8 (H, W) tensor: horizontal taps in int32 with weights
    round(2048 * w), the vertical pass as the vector path rounds it
    ((row >> 4) * w >> 16, summed, then (+2) >> 2)."""
    w, h = size
    H, W = img.shape
    x0, x1, ax0, ax1 = _linear_x(W, w, img.device)
    y0, y1, by0, by1 = _linear_y(H, h, img.device)
    src = img.to(torch.int32)
    rows = src[:, x0] * ax0 + src[:, x1] * ax1
    v = (((rows[y0] >> 4) * by0[:, None]) >> 16) + (
        ((rows[y1] >> 4) * by1[:, None]) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=512)
def _exact_taps(src, dst, device):
    """INTER_LINEAR_EXACT's taps for one axis: source index, next index,
    and their 8-bit weights; destinations left of the first or right of
    the last source centre take that pixel whole."""
    scale = 1.0 / (dst / src)
    f = (scale * (torch.arange(dst, dtype=torch.float64, device=device)
                  + 0.5) - 0.5)
    i = torch.floor(f)
    c1 = ((f - i) * 256).round().to(torch.int32)
    i = i.to(torch.int64)
    lo = i < 0 if src > 1 else torch.ones_like(i, dtype=torch.bool)
    hi = i >= src - 1
    c1 = torch.where(lo | hi, torch.zeros_like(c1), c1)
    i = torch.where(lo, torch.zeros_like(i), i.clamp(max=src - 1))
    return i, (i + 1).clamp(max=src - 1), 256 - c1, c1


def resize_linear_exact(img, size):
    """cv2.resize(img, size=(w, h), interpolation=INTER_LINEAR_EXACT) on a
    uint8 (H, W) tensor."""
    w, h = size
    H, W = img.shape
    x0, x1, cx0, cx1 = _exact_taps(W, w, img.device)
    y0, y1, cy0, cy1 = _exact_taps(H, h, img.device)
    src = img.to(torch.int32)
    rows = src[:, x0] * cx0 + src[:, x1] * cx1
    v = rows[y0] * cy0[:, None] + rows[y1] * cy1[:, None]
    return ((v + (1 << 15)) >> 16).to(torch.uint8)


@functools.lru_cache(maxsize=512)
def _reflect101(size, border, device):
    """Source index of each of size + 2 * border positions,
    BORDER_REFLECT_101 about a line of @size pixels."""
    i = torch.arange(-border, size + border, device=device)
    period = 2 * size - 2 if size > 1 else 1
    i = torch.remainder(i, period)
    return torch.where(i >= size, period - i, i)


def build_pyramid(gray, mask=None, n_levels=N_LEVELS):
    """The image pyramid as one uint8 stack (L, H + 2B, W + 2B), level l
    at [B:B + h_l, B:B + w_l] with B px of BORDER_REFLECT_101 around it,
    the mask pyramid (L, H, W) bool (all True without a mask), and the
    level sizes."""
    H, W = gray.shape
    dev = gray.device
    sizes = level_sizes(H, W, n_levels)
    stack = torch.zeros((n_levels, H + 2 * BORDER, W + 2 * BORDER),
                        dtype=torch.uint8, device=dev)
    masks = torch.zeros((n_levels, H, W), dtype=torch.bool, device=dev)
    img = gray
    m = None if mask is None else (mask != 0).to(torch.uint8) * 255
    for lev, (h, w) in enumerate(sizes):
        if lev > 0:
            img = resize_linear_exact(img, (w, h))
            if m is not None:
                m = resize_linear_exact(m, (w, h))
                m = torch.where(m > 254, m, torch.zeros_like(m))
        ry = _reflect101(h, BORDER, dev)
        rx = _reflect101(w, BORDER, dev)
        stack[lev, :h + 2 * BORDER, :w + 2 * BORDER] = img[ry[:, None],
                                                           rx[None, :]]
        masks[lev, :h, :w] = True if m is None else m != 0
    return stack, masks, sizes


def _gauss7():
    x = torch.arange(7, dtype=torch.float64) - 3.0
    t = torch.exp(-0.5 / 4.0 * x * x)
    return (t / t.sum()).to(torch.float32).tolist()


def gaussian_blur7(stack):
    """The float32 path of cv2's 7x7, sigma-2 Gaussian of a pyramid
    level: each (L, H + 6, W + 6) uint8 input gives its (L, H, W) centre.
    Rows are summed tap by tap in order, columns as the symmetric column
    filter sums them (centre, then each pair added before its tap), every
    step a fused multiply-add rounded once to float32 (done in float64,
    where the product and the sum are exact), the result rounded half to
    even."""
    k = _gauss7()
    L, Hp, Wp = stack.shape
    H, W = Hp - 6, Wp - 6
    f32, f64 = torch.float32, torch.float64
    src = stack.to(f64)
    r = (src[:, :, 0:W] * k[0]).to(f32)
    for i in range(1, 7):
        r = (r.to(f64) + src[:, :, i:i + W] * k[i]).to(f32)
    c = (r[:, 3:3 + H].to(f64) * k[3]).to(f32)
    for i in range(1, 4):
        pair = (r[:, 3 + i:3 + i + H] + r[:, 3 - i:3 - i + H]).to(f64)
        c = (c.to(f64) + pair * k[3 + i]).to(f32)
    return c.round().clamp(0, 255).to(torch.uint8)


def _ring_arcs(ring, op):
    """op over each of the 16 arcs of 9 contiguous ring pixels; ring is
    (16, ...) in circle order, op torch.minimum or torch.maximum."""
    e = torch.cat([ring, ring[:8]])               # ring, wrapped (24)
    m2 = op(e[:-1], e[1:])                        # pairs      (23)
    m4 = op(m2[:-2], m2[2:])                      # 4 in a row (21)
    m8 = op(m4[:-4], m4[4:])                      # 8 in a row (17)
    return op(m8[:16], e[8:24])                   # 9 in a row (16)


def fast_scores(stack, sizes, threshold, margin=3):
    """FAST-9/16 on each level's interior [3, h-3) x [3, w-3), computed
    on [margin, H - margin) of the level area (ORB needs no more than
    the 30 px rim its edge threshold leaves): a pixel is a corner where 9
    contiguous ring pixels are all brighter than it + t or all darker
    than it - t, and scores M - 1, M the largest over arcs and both signs
    of the arc's smallest |difference| (cv2's `cornerScore<16>`); 0
    elsewhere. With p the ring, M = max(v - min_arcs max(p), max_arcs
    min(p) - v), so the arcs are taken on the uint8 ring itself. Returns
    int16 (L, H, W)."""
    L = stack.shape[0]
    H = stack.shape[1] - 2 * BORDER
    W = stack.shape[2] - 2 * BORDER
    dev = stack.device
    h, w = H - 2 * margin, W - 2 * margin
    o = BORDER + margin
    ring = torch.stack([stack[:, o + dy:o + dy + h, o + dx:o + dx + w]
                        for dx, dy in _FAST_RING])
    v = stack[:, o:o + h, o:o + w].to(torch.int16)
    lo = _ring_arcs(ring, torch.maximum).amin(0).to(torch.int16)
    hi = _ring_arcs(ring, torch.minimum).amax(0).to(torch.int16)
    m = torch.maximum(v - lo, hi - v)
    hs, ws = to_device(sizes, dev, np.int64).T[:, :, None, None]
    yy = torch.arange(margin, H - margin, device=dev)[None, :, None]
    xx = torch.arange(margin, W - margin, device=dev)[None, None, :]
    inside = (yy >= 3) & (yy < hs - 3) & (xx >= 3) & (xx < ws - 3)
    score = torch.where(inside & (m > threshold), m - 1,
                        torch.zeros_like(m))
    return torch.nn.functional.pad(score, (margin,) * 4)


def fast_keypoints(scores):
    """Non-max suppression: a corner is kept where its score beats all 8
    neighbours' strictly. Returns bool (L, H, W)."""
    L, H, W = scores.shape
    p = torch.nn.functional.pad(scores, (1, 1, 1, 1))
    keep = scores > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= scores > p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return keep


def harris_responses(stack, H, W):
    """cv2's `HarrisResponses` at every pixel of the (L, H, W) level
    area: Sobel-like gradients summed over the 7x7 block in int32, then
    (a*b - c*c - k*(a+b)^2) * scale^4 in float32, in cv2's order."""
    s = stack.to(torch.int32)
    r = HARRIS_BLOCK // 2
    o = BORDER - r - 1                  # first row/col the block reads

    def px(dy, dx):
        return s[:, o + dy:o + dy + H + 2 * r, o + dx:o + dx + W + 2 * r]

    ix = ((px(1, 2) - px(1, 0)) * 2 + (px(0, 2) - px(0, 0))
          + (px(2, 2) - px(2, 0)))
    iy = ((px(2, 1) - px(0, 1)) * 2 + (px(2, 0) - px(0, 0))
          + (px(2, 2) - px(0, 2)))

    def box(v):                         # 7x7 sums by prefix sums
        c = torch.nn.functional.pad(v.cumsum(2), (1, 0))
        v = c[:, :, HARRIS_BLOCK:] - c[:, :, :-HARRIS_BLOCK]
        c = torch.nn.functional.pad(v.cumsum(1), (0, 0, 1, 0))
        return c[:, HARRIS_BLOCK:] - c[:, :-HARRIS_BLOCK]

    a = box(ix * ix).to(torch.float32)
    b = box(iy * iy).to(torch.float32)
    c = box(ix * iy).to(torch.float32)
    scale = np.float32(1.0) / np.float32(4 * HARRIS_BLOCK * 255.0)
    scale4 = float(np.float32(np.float32(scale * scale) * scale) * scale)
    ab = a + b
    return ((a * b - c * c) - (ab * HARRIS_K) * ab) * scale4


def _retain_best_fast(keep, scores, quota):
    """Per level, the keypoints whose FAST score is at least the
    quota-th best (all of them when there are no more than quota)."""
    L = keep.shape[0]
    dev = keep.device
    idx = (torch.arange(L, device=dev)[:, None, None] * 256
           + scores.to(torch.int64)).reshape(-1)
    hist = torch.zeros(L * 256, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, idx, keep.reshape(-1).to(torch.int64))
    at_least = hist.reshape(L, 256).flip(1).cumsum(1).flip(1)
    q = to_device(quota, dev, np.int64)[:, None]
    thr = (at_least >= q).sum(1) - 1          # -1: keep all
    return keep & (scores >= thr[:, None, None])


def _retain_best_harris(keep, resp, quota):
    """Per level, the keypoints whose Harris response is at least the
    quota-th best among them (ties at the boundary kept)."""
    L = keep.shape[0]
    dev = keep.device
    flat = torch.where(keep, resp, torch.full_like(resp, -math.inf))
    flat = flat.reshape(L, -1)
    k = min(max(quota), flat.shape[1])
    if k == 0:
        return torch.zeros_like(keep)
    top = torch.topk(flat, k, dim=1).values
    q = to_device([min(max(x, 1), k) - 1 for x in quota], dev, np.int64)
    thr = top.gather(1, q[:, None])[:, 0]
    some = to_device([x > 0 for x in quota], dev, bool)
    return keep & (resp >= thr[:, None, None]) & some[:, None, None]


@functools.lru_cache(maxsize=8)
def _constant(name, device):
    """The detector's constant tables on @device, uploaded once."""
    values = {"disc": _disc_offsets, "pattern": lambda: PATTERN,
              "scales": level_scales}[name]()
    dtype = np.float32 if name in ("pattern", "scales") else np.int64
    return to_device(values, device, dtype)


def _disc_offsets(half=PATCH_SIZE // 2):
    """(du, dv) of the circular patch `ICAngles` sums over: row v spans
    |u| <= umax[v], umax built as cv2 builds it (symmetric in u and v)."""
    umax = [0] * (half + 2)
    vmax = math.floor(half * math.sqrt(2.0) / 2 + 1)
    vmin = math.ceil(half * math.sqrt(2.0) / 2)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    offs = [(u, 0) for u in range(-half, half + 1)]
    for v in range(1, half + 1):
        offs += [(u, s * v) for s in (1, -1)
                 for u in range(-umax[v], umax[v] + 1)]
    return offs


_ATAN_P = [float(np.float32(np.float32(c) * np.float32(180 / math.pi)))
           for c in (0.9997878412794807, -0.3258083974640975,
                     0.1555786518463281, -0.04432655554792128)]


def fast_atan2(y, x):
    """cv2.fastAtan2 in float32: degrees in [0, 360) from a 7th-order
    polynomial of min(|x|, |y|) / max(|x|, |y|)."""
    p1, p3, p5, p7 = _ATAN_P
    eps = float(np.float32(np.finfo(np.float64).eps))
    ax, ay = x.abs(), y.abs()
    flat = ax >= ay
    c = torch.where(flat, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(flat, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def ic_angles(stack, lev, ys, xs):
    """Orientation in degrees of keypoints at level-area (ys, xs) of
    levels @lev: fastAtan2(m01, m10) of the intensity moments over the
    radius-15 disc of the unblurred level."""
    L, Hp, Wp = stack.shape
    dev = stack.device
    offs = _constant("disc", dev)
    base = lev * (Hp * Wp) + (ys + BORDER) * Wp + (xs + BORDER)
    idx = base[:, None] + offs[None, :, 1] * Wp + offs[None, :, 0]
    val = stack.reshape(-1)[idx].to(torch.int64)
    m10 = (val * offs[None, :, 0]).sum(1).to(torch.float32)
    m01 = (val * offs[None, :, 1]).sum(1).to(torch.float32)
    return fast_atan2(m01, m10)


def rbrief(blurred, lev, ys, xs, angle):
    """(n, 32) uint8 descriptors at level-area (ys, xs) of levels @lev of
    the blurred (L, H, W) stack: PATTERN rotated by @angle (degrees), in
    float32 as cv2 rotates it, each point rounded half to even."""
    L, H, W = blurred.shape
    dev = blurred.device
    pat = _constant("pattern", dev).reshape(-1, 2)
    rad = angle * float(np.float32(math.pi / 180.0))
    ca = torch.cos(rad.to(torch.float64)).to(torch.float32)[:, None]
    sa = torch.sin(rad.to(torch.float64)).to(torch.float32)[:, None]
    px = pat[None, :, 0] * ca - pat[None, :, 1] * sa
    py = pat[None, :, 0] * sa + pat[None, :, 1] * ca
    idx = (lev[:, None] * (H * W) + (ys[:, None] + py.round().long()) * W
           + xs[:, None] + px.round().long())
    val = blurred.reshape(-1)[idx]
    bits = (val[:, 0::2] < val[:, 1::2]).to(torch.uint8).reshape(-1, 32, 8)
    weight = (1 << torch.arange(8, device=dev)).to(torch.uint8)
    return (bits * weight).sum(2).to(torch.uint8)


def detect_and_compute(gray, mask=None, n_features=2000, fast_threshold=5,
                       descriptors=True):
    """ORB on a uint8 (H, W) grey image (and an optional mask, nonzero =
    usable) on its device. Returns a dict of tensors on that device:
    "pt" (n, 2) float32 keypoints in image pixels, "octave" (n,) int64,
    "angle" (n,) float32 degrees, "response" (n,) float32 Harris, and
    "des" (n, 32) uint8 (when @descriptors). Keypoints come level by level,
    each level in raster order."""
    dev = gray.device
    H, W = gray.shape
    stack, masks, sizes = build_pyramid(gray, mask)
    quota = level_quotas(n_features)
    scores = fast_scores(stack, sizes, int(fast_threshold),
                         margin=EDGE_THRESHOLD - 1)
    keep = fast_keypoints(scores) & masks
    hs, ws = to_device(sizes, dev, np.int64).T[:, :, None, None]
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    e = EDGE_THRESHOLD
    keep &= ((yy >= e) & (yy < hs - e) & (xx >= e) & (xx < ws - e)
             & (hs > 2 * e) & (ws > 2 * e))
    keep = _retain_best_fast(keep, scores, [2 * q for q in quota])
    resp = harris_responses(stack, H, W)
    keep = _retain_best_harris(keep, resp, quota)
    with span("pull.track.orb_detect"):
        lev, ys, xs = keep.nonzero(as_tuple=True)      # the one host sync
    angle = ic_angles(stack, lev, ys, xs)
    scale = _constant("scales", dev)[lev]
    out = {"pt": torch.stack([xs.to(torch.float32) * scale,
                              ys.to(torch.float32) * scale], 1),
           "octave": lev, "angle": angle, "response": resp[lev, ys, xs]}
    if descriptors:
        blurred = gaussian_blur7(stack[:, BORDER - 3:BORDER + H + 3,
                                       BORDER - 3:BORDER + W + 3])
        out["des"] = rbrief(blurred, lev, ys, xs, angle)
    return out
