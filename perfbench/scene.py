"""The benchmark's RGBD scene: three textured boxes seen from a camera
orbiting them, rendered on the device.

A torch copy of the repository's numpy fixture
(`tests/synthetic.py::render_boxes_depth` and `cube_orbit_sequence`),
batched over frames and run on the card, so a run renders hundreds of
480x640 frames in its set-up. Arithmetic is float64, as in the fixture, so
both give the same pixels. The seed moves the orbit's start angle, the
camera's height and the box colours within the ranges the traffic mix
gives (a mix may pin them, so that every seed does the same work), and
the depth noise; never a size.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SHADES = (1.0, 0.82, 0.65)
# the face-unique glyph dots (6 signed faces, 2 dots, uv in [-1, 1])
GLYPH_UV = [
    [[-0.55, -0.55], [0.55, 0.55]],
    [[-0.55, 0.55], [0.55, -0.55]],
    [[0.0, -0.55], [0.0, 0.55]],
    [[-0.55, 0.0], [0.55, 0.0]],
    [[-0.55, -0.55], [-0.55, 0.55]],
    [[0.55, -0.55], [0.55, 0.55]],
]
BASE_COLORS = ((200, 60, 60), (60, 200, 60), (60, 60, 220))


def intrinsics(H: int, W: int) -> np.ndarray:
    """The fixture's pinhole camera: f = 0.9 max(H, W), centred."""
    f = 0.9 * max(H, W)
    return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]],
                    dtype=np.float64)


def boxes(obj_size: float, colors=BASE_COLORS):
    """(center, half, colour) of the three boxes, as the fixture's."""
    s = obj_size
    return [((0, 0, 0), (s, s, s), colors[0]),
            ((s * 0.9, 0, s * 0.9), (s * 0.45,) * 3, colors[1]),
            ((-s * 0.8, s * 0.7, 0), (s * 0.35,) * 3, colors[2])]


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    """cam-to-world, OpenCV convention (+z forward, +y down)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def orbit_poses(n: int, angle0: float, step: float, radius: float,
                height: float) -> np.ndarray:
    """(n, 4, 4) cam-in-object poses on the orbit, frame i at angle
    angle0 + i * step."""
    out = []
    for i in range(n):
        a = angle0 + step * i
        out.append(look_at((radius * math.sin(a), height,
                            radius * math.cos(a))))
    return np.stack(out)


def render(cam_in_obs, K, H: int, W: int, box_list, device,
           chunk: int = 32):
    """Color (N,H,W,3) uint8, z-depth (N,H,W) float32 and mask (N,H,W)
    uint8 of the boxes seen from @cam_in_obs (N,4,4), as device tensors;
    the fixture's ray-box march, shading, checkerboard, speckle and glyph
    dots, in float64."""
    dev = torch.device(device)
    f64 = torch.float64
    vs, us = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    dirs = torch.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                        torch.ones_like(us)], dim=-1)            # (H,W,3)
    shades = torch.tensor(SHADES, dtype=f64, device=dev)
    glyph = torch.tensor(GLYPH_UV, dtype=f64, device=dev)
    poses = torch.as_tensor(np.asarray(cam_in_obs), dtype=f64, device=dev)
    colors, depths, masks = [], [], []
    for s in range(0, len(poses), chunk):
        P = poses[s:s + chunk]
        n = P.shape[0]
        R, o = P[:, :3, :3], P[:, :3, 3]
        dirs_w = torch.einsum("hwj,nij->nhwi", dirs, R)          # (n,H,W,3)
        o = o[:, None, None, :]
        depth = torch.full((n, H, W), float("inf"), dtype=f64, device=dev)
        color = torch.zeros((n, H, W, 3), dtype=torch.uint8, device=dev)
        inv = 1.0 / torch.where(dirs_w.abs() < 1e-12,
                                torch.full_like(dirs_w, 1e-12), dirs_w)
        for center, half, col in box_list:
            center = torch.tensor(center, dtype=f64, device=dev)
            half = torch.tensor(half, dtype=f64, device=dev)
            t0 = (center - half - o) * inv
            t1 = (center + half - o) * inv
            tmin = torch.minimum(t0, t1).amax(dim=-1)
            tmax = torch.maximum(t0, t1).amin(dim=-1)
            hit = tmax > tmin.clamp(min=0.0)
            t = torch.where(hit, tmin, torch.full_like(tmin, float("inf")))
            z = t * dirs[..., 2]
            upd = hit & (z < depth)
            depth = torch.where(upd, z, depth)
            t_safe = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
            pts = o + t_safe[..., None] * dirs_w
            rel = (pts - center) / half
            face = torch.argmax(rel.abs(), dim=-1)
            shade = shades[face]
            fu = torch.gather(rel, -1, ((face + 1) % 3)[..., None])[..., 0]
            fv = torch.gather(rel, -1, ((face + 2) % 3)[..., None])[..., 0]
            checker = torch.remainder(torch.floor(fu * 6)
                                      + torch.floor(fv * 6), 2)
            speckle = 0.5 + 0.5 * torch.sin(37.0 * fu + 61.0 * fv * fu
                                            + 13.0 * fv)
            shade = shade * (0.55 + 0.3 * checker + 0.15 * speckle)
            sgn = torch.gather(rel, -1, face[..., None])[..., 0] < 0
            g = glyph[face * 2 + sgn.long()]                      # (..,2,2)
            hit_g = (torch.maximum((fu[..., None] - g[..., 0]).abs(),
                                   (fv[..., None] - g[..., 1]).abs())
                     < 0.16).any(dim=-1)
            shade = torch.where(hit_g, shade * 0.25, shade)
            for c in range(3):
                ch = torch.clamp(col[c] * shade, 0, 255).to(torch.uint8)
                color[..., c] = torch.where(upd, ch, color[..., c])
        finite = torch.isfinite(depth)
        masks.append(finite.to(torch.uint8))
        depths.append(torch.where(finite, depth,
                                  torch.zeros_like(depth)).float())
        colors.append(color)
    return torch.cat(colors), torch.cat(depths), torch.cat(masks)


def erode(mask, k: int):
    """Binary erosion with a k x k window whose pixels outside the image
    never lower it (`run_custom.erode_mask`, cv2.erode's default border):
    the minimum over the window. @mask: (N,H,W) uint8 device tensor."""
    if k <= 1:
        return mask
    lo, hi = k // 2, k - 1 - k // 2
    m = torch.nn.functional.pad((1 - mask).float()[:, None], (lo, hi, lo, hi),
                                value=0.0)
    return (1 - (torch.nn.functional.max_pool2d(m, k, stride=1)[:, 0] > 0)
            .to(torch.uint8)).to(torch.uint8)


def seeded_scene(seed: int, p: dict, n_frames: int, device):
    """The frames of one traffic mix @p (see `traffic/*.json`) for @seed,
    rendered on @device and handed back as host numpy arrays, as a live
    RGBD camera hands them: colors (N,H,W,3) uint8, depths (N,H,W) float32
    metres with the seeded noise (zero off the object), masks (N,H,W)
    uint8 after the mix's erosion, K, the true cam-in-object poses and the
    frame ids. Frame i lies at angle0 + i * step on the orbit."""
    rng = np.random.default_rng(seed)
    H, W = int(p["H"]), int(p["W"])
    angle0 = float(rng.uniform(0.0, 2.0 * math.pi))
    height = float(rng.uniform(*p["height_range"]))
    jitter = int(p.get("color_jitter", 0))
    cols = [tuple(int(np.clip(c + rng.integers(-jitter, jitter + 1), 40, 240))
                  for c in base) for base in BASE_COLORS]
    K = intrinsics(H, W)
    poses = orbit_poses(n_frames, angle0, float(p["step_rad"]),
                        float(p["radius"]), height)
    color, depth, mask = render(poses, K, H, W,
                                boxes(float(p["obj_size"]), cols), device)
    noise = float(p.get("depth_noise_m", 0.0))
    if noise > 0:
        gen = torch.Generator(device=depth.device).manual_seed(
            int(rng.integers(0, 2 ** 62)))
        depth = depth + (torch.randn(depth.shape, generator=gen,
                                     device=depth.device) * noise
                         * mask.float())
    mask = erode(mask, int(p.get("erode_mask", 0)))
    return {"colors": color.cpu().numpy(), "depths": depth.cpu().numpy(),
            "masks": mask.cpu().numpy(), "K": K, "cam_in_obs": poses,
            "id_strs": [f"{i:05d}" for i in range(n_frames)],
            "angle0": angle0, "height": height, "box_colors": cols}
