"""A synthetic video written the way HO3D lays its files out, for the HO3D
path's tests and `chip_smoke.py`'s phase 16.

    <root>/evaluation/<name>/rgb/<id>.jpg
    <root>/evaluation/<name>/depth/<id>.png     R + 256 G = depth / DEPTH_SCALE
    <root>/evaluation/<name>/meta/<id>.pkl      camMat, objRot, objTrans (GL)
    <root>/evaluation/<name>/visible_mesh.ply   the GT surface the frames saw
    <root>/masks_XMem/<name>/<index:05d>.png
    <root>/masks_XMem/<name>_hand/<index:04d>.png

Everything but the JPEGs is written here with the port's own writers
(`utils/png.py`, pickle, `mesh.Mesh.export`), so it runs where neither
cv2 nor Pillow is installed. The JPEGs are either copied (the committed
fixture `fixtures/ho3d_orbit30/`, made by `fixtures/gen_ho3d_layout.py`,
since the GPU machine has no JPEG encoder) or encoded here with Pillow at
quality 95, 4:2:0, as that generator does.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

DEPTH_SCALE = 0.00012498664727900177      # Ho3dReader.DEPTH_SCALE
FIXTURE_DIR = os.path.join(HERE, "fixtures", "ho3d_orbit30")
HASHES = os.path.join(FIXTURE_DIR, "sha256.json")
JPEG_QUALITY = 95
# OpenGL camera in OpenCV camera, its own inverse (utils/common.py)
GLCAM_IN_CVCAM = np.diag([1.0, -1.0, -1.0, 1.0])


def orbit_sequence(n_frames=30):
    """The frames the fixture's JPEGs hold: the first @n_frames of the
    120-frame easy orbit at 480x640 (phase 7's sequence)."""
    from synthetic import cube_orbit_sequence
    return cube_orbit_sequence(n_frames=n_frames, H=480, W=640, radius=0.45,
                               obj_size=0.08,
                               full_angle=2 * np.pi * n_frames / 120,
                               noise=0.002, seed=0)


def fixture_jpegs(n_frames=30):
    """The committed JPEG of each of the first @n_frames frames."""
    return [os.path.join(FIXTURE_DIR, "rgb", f"{i:04d}.jpg")
            for i in range(n_frames)]


def pixel_sha256(img) -> str:
    """SHA-256 of decoded pixels, with their shape and dtype."""
    a = np.ascontiguousarray(img)
    return hashlib.sha256(f"{a.shape}{a.dtype}".encode()
                          + a.tobytes()).hexdigest()


def load_hashes() -> dict:
    with open(HASHES) as f:
        return json.load(f)


def encode_jpeg(rgb, path, quality=JPEG_QUALITY):
    """A baseline JPEG of @rgb through Pillow (4:2:0, libjpeg's default)."""
    from PIL import Image
    Image.fromarray(np.asarray(rgb, np.uint8)).save(
        path, "JPEG", quality=quality, subsampling=2)


def pack_depth(depth):
    """HO3D's two-channel depth: d = round(depth / DEPTH_SCALE), low byte
    in R, high byte in G, B zero (8-bit RGB in file order)."""
    d = np.clip(np.round(np.asarray(depth, np.float64) / DEPTH_SCALE), 0,
                65535).astype(np.uint32)
    return np.stack([d & 255, d >> 8, np.zeros_like(d)], -1).astype(np.uint8)


def gl_meta(K, ob_in_cam):
    """The meta pickle's fields for a cv-convention @ob_in_cam: the GL
    pose (GLCAM_IN_CVCAM @ ob_in_cam) as objRot (3, 1) axis-angle, in
    cv2.Rodrigues's arithmetic, and objTrans (3,)."""
    from bundlesdf_tpu_torch.utils.se3 import so3_log_np
    T = GLCAM_IN_CVCAM @ np.asarray(ob_in_cam, np.float64)
    return {"camMat": np.asarray(K, np.float64),
            "objRot": so3_log_np(T[:3, :3]).reshape(3, 1),
            "objTrans": T[:3, 3].copy()}


def visible_points(seq, n_frames, model_pts, radius=0.005):
    """The GT surface points within @radius of a masked depth map lifted
    with its GT pose."""
    from scipy.spatial import cKDTree
    from bundlesdf_tpu_torch.utils.common import depth2xyzmap
    pts = []
    for i in range(n_frames):
        d = seq["depths"][i].astype(np.float64)
        xyz = depth2xyzmap(d, seq["K"])[(d >= 0.1) & (seq["masks"][i] > 0)]
        T = seq["cam_in_obs"][i]
        pts.append(xyz[::4] @ T[:3, :3].T + T[:3, 3])
    dist, _ = cKDTree(np.concatenate(pts)).query(model_pts, k=1)
    return model_pts[dist < radius]


def write_ho3d_video(root, seq, name="SYN1", n_frames=None, jpegs=None,
                     hand_absent=(1,), trans_none=(), model_pts=None,
                     depth_dtype=np.uint8):
    """Write the first @n_frames of @seq (`cube_orbit_sequence`'s dict) as
    HO3D video @name under @root; returns its video dir. @jpegs: JPEG
    files to copy as rgb/ (else Pillow encodes the frames). Hand masks are
    all zero, with no file for the frames in @hand_absent; the frames in
    @trans_none get objTrans None. @model_pts: GT surface samples (object
    frame) for visible_mesh.ply, default `gt_surface_points(20000)`.
    @depth_dtype: the depth PNGs' sample type; HO3D's are 8-bit, and
    np.uint16 writes the same values as 16-bit samples."""
    from bundlesdf_tpu_torch.mesh import Mesh
    from bundlesdf_tpu_torch.utils.png import write_png
    n = len(seq["id_strs"]) if n_frames is None else n_frames
    video = os.path.join(root, "evaluation", name)
    masks = os.path.join(root, "masks_XMem", name)
    hands = os.path.join(root, "masks_XMem", f"{name}_hand")
    for d in ("rgb", "depth", "meta"):
        os.makedirs(os.path.join(video, d), exist_ok=True)
    for d in (masks, hands):
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        id_str = seq["id_strs"][i]
        index = int(id_str)
        rgb = os.path.join(video, "rgb", f"{id_str}.jpg")
        if jpegs is not None:
            shutil.copyfile(jpegs[i], rgb)
        else:
            encode_jpeg(seq["colors"][i], rgb)
        write_png(os.path.join(video, "depth", f"{id_str}.png"),
                  pack_depth(seq["depths"][i]).astype(depth_dtype))
        meta = gl_meta(seq["K"], np.linalg.inv(seq["cam_in_obs"][i]))
        if i in trans_none:
            meta["objTrans"] = None
        with open(os.path.join(video, "meta", f"{id_str}.pkl"), "wb") as f:
            pickle.dump(meta, f)
        write_png(os.path.join(masks, f"{index:05d}.png"),
                  (seq["masks"][i] > 0).astype(np.uint8) * 255)
        if i not in hand_absent:
            write_png(os.path.join(hands, f"{index:04d}.png"),
                      np.zeros(seq["masks"][i].shape, np.uint8))
    if model_pts is None:
        from bundlesdf_tpu_torch.benchmark_synthetic import gt_surface_points
        model_pts = gt_surface_points(20000)
    vis = visible_points(seq, n, np.asarray(model_pts, np.float64))
    Mesh(vis, np.zeros((0, 3), np.int64)).export(
        os.path.join(video, "visible_mesh.ply"))
    return video
