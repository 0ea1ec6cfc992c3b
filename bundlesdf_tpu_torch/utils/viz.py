"""Pose visualization helpers (ref `Utils.py:309-344` draw_xyz_axis,
`Utils.py:517-553` draw_posed_3d_box), drawn in numpy.

Counterpart of `bundlesdf_tpu/utils/viz.py`, which draws with cv2. The
8-connected lines (`draw_line`) repeat cv2.line's LINE_8 rasterization,
so they are pixel-equal to it: thickness 1 is its Bresenham walk
(`LineIterator`, left to right, clipped to the image); a thicker line is
first clipped to the image grown by its thickness, then drawn as the
quadrilateral cv2 fills in 16.16 fixed point (`FillConvexPoly`, edges by
`Line2`) plus a filled circle at each end. The arrows of
`draw_xyz_axis` are anti-aliased by coverage of a capsule of the line's
width, close to cv2's LINE_AA but not equal to it."""
from __future__ import annotations

import math

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT


def project_points(pts, K, ob_in_cam):
    """(N,3) object points -> (N,2) pixel coords under ob_in_cam."""
    p = pts @ ob_in_cam[:3, :3].T + ob_in_cam[:3, 3]
    uv = p[:, :2] / np.maximum(p[:, 2:3], 1e-9)
    return np.stack([uv[:, 0] * K[0, 0] + K[0, 2],
                     uv[:, 1] * K[1, 1] + K[1, 2]], axis=-1), p[:, 2]


def _clip_line(w, h, x1, y1, x2, y2):
    """cv2's `clipLine` to [0, w-1] x [0, h-1] (integer coordinates, the
    cut points truncated toward zero). Returns the clipped ends or None."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_pixels(w, h, p0, p1):
    """The pixels of cv2's 8-connected `Line` (its `LineIterator`, left to
    right) from integer @p0 to @p1, clipped to the image."""
    x1, y1 = p0
    x2, y2 = p1
    if not (0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return []
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0
    return out


def _line2_pixels(w, h, p0, p1):
    """The pixels of cv2's `Line2`: the 8-connected line between 16.16
    fixed-point ends, stepping one pixel along the major axis."""
    clipped = _clip_line(w << _SHIFT, h << _SHIFT, *p0, *p1)
    if clipped is None:
        return []
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    out = []
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        x_step, y_step = _ONE, _div_trunc(dy << _SHIFT, ax | 1)
        ecount = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        x_step, y_step = _div_trunc(dx << _SHIFT, ay | 1), _ONE
        ecount = (y2 - y1) >> _SHIFT
    x1 += _ONE >> 1
    y1 += _ONE >> 1
    out.append(((x2 + (_ONE >> 1)) >> _SHIFT, (y2 + (_ONE >> 1)) >> _SHIFT))
    if ax > ay:
        x1 >>= _SHIFT
        while ecount >= 0:
            out.append((x1, y1 >> _SHIFT))
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= _SHIFT
        while ecount >= 0:
            out.append((x1 >> _SHIFT, y1))
            x1 += x_step
            y1 += 1
            ecount -= 1
    return [(x, y) for x, y in out if 0 <= x < w and 0 <= y < h]


def _div_trunc(a, b):
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex(img, v, color):
    """cv2's `FillConvexPoly` of the 16.16 fixed-point polygon @v at
    LINE_8: its edges by `Line2`, then the scanlines between the two edges
    walked down from the top vertex."""
    h, w = img.shape[:2]
    n = len(v)
    for i in range(n):
        for x, y in _line2_pixels(w, h, v[i - 1], v[i]):
            img[y, x] = color
    delta = _ONE >> 1
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = int(np.argmin(ys))
    xmin = (min(xs) + delta) >> _SHIFT
    xmax = (max(xs) + delta) >> _SHIFT
    ymin = (min(ys) + delta) >> _SHIFT
    ymax = (max(ys) + delta) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    edge = [dict(idx=imin, di=1, x=-_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> _SHIFT
                    if ty > y:
                        xs_, xe_ = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _div_trunc((xe_ - xs_) * 2 + (ty - y),
                                             2 * (ty - y))
                        e["x"] = xs_
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = ((1, 0) if edge[0]["x"] > edge[1]["x"]
                           else (0, 1))
            xx1 = (edge[left]["x"] + delta) >> _SHIFT
            xx2 = (edge[right]["x"] + delta) >> _SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _fill_circle(img, cx, cy, radius, color):
    """cv2's filled `Circle` (midpoint walk, horizontal spans)."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1

    def span(y, x0, x1):
        if 0 <= y < h and x1 >= 0 and x0 < w:
            img[y, max(x0, 0):min(x1, w - 1) + 1] = color

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def draw_line(img, p0, p1, color, thickness=1):
    """cv2.line(img, p0, p1, color, thickness) at LINE_8, in place, for
    integer ends; returns @img."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)[:img.shape[2]] if img.ndim == 3 \
        else color
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        for x, y in _line_pixels(w, h, (x0, y0), (x1, y1)):
            img[y, x] = color
        return img
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, x0 + t, y0 + t, x1 + t,
                         y1 + t)
    if clipped is None:
        return img
    x0, y0, x1, y1 = (c - t for c in clipped)
    fx0, fy0, fx1, fy1 = (x0 << _SHIFT, y0 << _SHIFT, x1 << _SHIFT,
                          y1 << _SHIFT)
    dx = (fx0 - fx1) / _ONE
    dy = (fy1 - fy0) / _ONE
    r = dx * dx + dy * dy
    half = thickness << (_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * _ONE * 0.5) / math.sqrt(r)
        px, py = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(fx0 + px, fy0 + py), (fx0 - px, fy0 - py),
                           (fx1 - px, fy1 - py), (fx1 + px, fy1 + py)],
                     color)
    rad = (half + (_ONE >> 1)) >> _SHIFT
    for cx, cy in ((x0, y0), (x1, y1)):
        _fill_circle(img, cx, cy, rad, color)
    return img


def draw_line_aa(img, p0, p1, color, thickness=1):
    """An anti-aliased line in place: each pixel blends toward @color by
    its coverage of a capsule around the segment. The capsule is as wide as
    cv2's LINE_AA draws a thick line: its half-width is thickness / 2, half
    a pixel more for an odd thickness, and its fringe fades to 0 from 0.2 to
    1.2 px beyond that. Returns @img."""
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    rad = (thickness + (thickness & 1)) / 2.0 + 0.7
    lo = np.floor(np.minimum(p0, p1) - rad - 1).astype(int)
    hi = np.ceil(np.maximum(p0, p1) + rad + 1).astype(int)
    x0, y0 = max(lo[0], 0), max(lo[1], 0)
    x1, y1 = min(hi[0], w - 1), min(hi[1], h - 1)
    if x1 < x0 or y1 < y0:
        return img
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    q = np.stack([xs, ys], -1).astype(np.float64)
    d = p1 - p0
    t = np.clip(((q - p0) @ d) / max(d @ d, 1e-12), 0.0, 1.0)
    dist = np.linalg.norm(q - (p0 + t[..., None] * d), axis=-1)
    a = np.clip(rad + 0.5 - dist, 0.0, 1.0)[..., None]
    region = img[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    c = np.asarray(color, np.float64)[:img.shape[2]]
    img[y0:y1 + 1, x0:x1 + 1] = np.rint(region * (1 - a) + c * a).astype(
        img.dtype)
    return img


def draw_arrow_aa(img, p0, p1, color, thickness=1, tip_length=0.1):
    """cv2.arrowedLine's geometry (the shaft, then two tip strokes of
    @tip_length x the shaft at +/-45 degrees, ends rounded half to even),
    drawn with `draw_line_aa`. Returns @img."""
    tip = math.hypot(p0[0] - p1[0], p0[1] - p1[1]) * tip_length
    draw_line_aa(img, p0, p1, color, thickness)
    ang = math.atan2(p0[1] - p1[1], p0[0] - p1[0])
    for s in (1, -1):
        p = (int(np.rint(p1[0] + tip * math.cos(ang + s * math.pi / 4))),
             int(np.rint(p1[1] + tip * math.sin(ang + s * math.pi / 4))))
        draw_line_aa(img, p, p1, color, thickness)
    return img


def draw_posed_3d_box(K, img, ob_in_cam, bbox, line_color=(0, 255, 0),
                      linewidth=2):
    """Draw the wireframe of an axis-aligned (in object frame) 3D box.
    @bbox: (2,3) [min_xyz, max_xyz]."""
    mn, mx = np.asarray(bbox[0]), np.asarray(bbox[1])
    corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                        for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    uv, z = project_points(corners, K, ob_in_cam)
    img = img.copy()
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    for a, b in edges:
        if z[a] <= 0 or z[b] <= 0:
            continue
        draw_line(img, tuple(np.round(uv[a]).astype(int)),
                  tuple(np.round(uv[b]).astype(int)), line_color, linewidth)
    return img


def draw_xyz_axis(color, ob_in_cam, K, scale=0.1, thickness=3):
    """Draw object-frame XYZ axes (x red, y green, z blue), anti-aliased."""
    pts = np.array([[0, 0, 0], [scale, 0, 0], [0, scale, 0], [0, 0, scale]],
                   np.float64)
    uv, z = project_points(pts, K, ob_in_cam)
    img = color.copy()
    if (z <= 0).any():
        return img
    o = tuple(np.round(uv[0]).astype(int))
    for i, c in [(1, (0, 0, 255)), (2, (0, 255, 0)), (3, (255, 0, 0))]:
        draw_arrow_aa(img, o, tuple(np.round(uv[i]).astype(int)), c,
                      thickness)
    return img
