"""Software z-buffer rasterizer (depth + face id + barycentrics).

Copy of `bundlesdf_tpu/mesh/render.py`, which replaces the pyrender/EGL
offscreen renderer (`offscreen_renderer.py:35-157`) used for texture-bake
visibility and GUI mesh views. Host numpy, chunked over faces — this runs
offline, not in the tracking hot path, so clarity beats speed; the
per-face inner loops are fully vectorized. The native C++ twin in
`native/` is the production path.
"""
from __future__ import annotations

import numpy as np


def rasterize(vertices, faces, K, ob_in_cam, H, W, znear=0.001):
    """Rasterize a mesh into a pinhole camera.

    @vertices: (V,3) object-space; @faces: (F,3); @ob_in_cam: (4,4).
    Returns dict: depth (H,W) float32 (0 = background), face_id (H,W) int32
    (-1 = background), bary (H,W,3) float32.

    Dispatches to the native C++ path (native/src/rasterizer.cpp) when
    built; the numpy body below is the reference/fallback implementation.
    `rasterize.last_path` records which one ran.
    """
    from bundlesdf_tpu_torch.native import rasterize_native
    out = rasterize_native(vertices, faces, K, np.asarray(ob_in_cam), H, W,
                           znear)
    rasterize.last_path = "numpy" if out is None else "native"
    if out is not None:
        return out
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    cam_pts = vertices @ ob_in_cam[:3, :3].T + ob_in_cam[:3, 3]
    z = cam_pts[:, 2]
    u = cam_pts[:, 0] / np.maximum(z, 1e-12) * K[0, 0] + K[0, 2]
    v = cam_pts[:, 1] / np.maximum(z, 1e-12) * K[1, 1] + K[1, 2]

    depth = np.zeros((H, W), np.float32)
    face_id = np.full((H, W), -1, np.int32)
    bary_out = np.zeros((H, W, 3), np.float32)
    zbuf = np.full((H, W), np.inf)

    tri_u = u[faces]  # (F,3)
    tri_v = v[faces]
    tri_z = z[faces]
    ok = (tri_z > znear).all(axis=1)
    # cull fully off-screen triangles
    ok &= (tri_u.max(1) >= 0) & (tri_u.min(1) < W) \
        & (tri_v.max(1) >= 0) & (tri_v.min(1) < H)
    idxs = np.nonzero(ok)[0]

    for fi in idxs:
        us, vs, zs = tri_u[fi], tri_v[fi], tri_z[fi]
        x0 = max(int(np.floor(us.min())), 0)
        x1 = min(int(np.ceil(us.max())) + 1, W)
        y0 = max(int(np.floor(vs.min())), 0)
        y1 = min(int(np.ceil(vs.max())) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1) + 0.0, np.arange(y0, y1) + 0.0)
        d = ((us[1] - us[0]) * (vs[2] - vs[0])
             - (us[2] - us[0]) * (vs[1] - vs[0]))
        if abs(d) < 1e-12:
            continue
        w0 = ((us[1] - xs) * (vs[2] - ys) - (us[2] - xs) * (vs[1] - ys)) / d
        w1 = ((us[2] - xs) * (vs[0] - ys) - (us[0] - xs) * (vs[2] - ys)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        inv_z = w0 / zs[0] + w1 / zs[1] + w2 / zs[2]
        zp = 1.0 / np.maximum(inv_z, 1e-12)
        sub_z = zbuf[y0:y1, x0:x1]
        upd = inside & (zp < sub_z)
        if not upd.any():
            continue
        sub_z[upd] = zp[upd]
        zbuf[y0:y1, x0:x1] = sub_z
        fid = face_id[y0:y1, x0:x1]
        fid[upd] = fi
        face_id[y0:y1, x0:x1] = fid
        for c, wgt in enumerate((w0, w1, w2)):
            bb = bary_out[y0:y1, x0:x1, c]
            bb[upd] = wgt[upd]
            bary_out[y0:y1, x0:x1, c] = bb

    hit = np.isfinite(zbuf)
    depth[hit] = zbuf[hit].astype(np.float32)
    return {"depth": depth, "face_id": face_id, "bary": bary_out}


# which path the last call took: "native" or "numpy"
rasterize.last_path = None


def render_color(mesh, K, ob_in_cam, H, W, light_dir=(0, 0, 1)):
    """Lambert-shaded color render (GUI mesh view replacement)."""
    out = rasterize(mesh.vertices, mesh.faces, K, ob_in_cam, H, W)
    img = np.zeros((H, W, 3), np.uint8)
    fid = out["face_id"]
    hit = fid >= 0
    if not hit.any():
        return img, out["depth"]
    fn = np.cross(
        mesh.vertices[mesh.faces[:, 1]] - mesh.vertices[mesh.faces[:, 0]],
        mesh.vertices[mesh.faces[:, 2]] - mesh.vertices[mesh.faces[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    fn_cam = fn @ ob_in_cam[:3, :3].T
    shade = np.abs(fn_cam @ np.asarray(light_dir, np.float64))
    if mesh.vertex_colors is not None:
        vc = mesh.vertex_colors.astype(np.float64)
        if vc.max() <= 1.0:
            vc = vc * 255
        fc = vc[mesh.faces].mean(axis=1)
    else:
        fc = np.full((len(mesh.faces), 3), 200.0)
    col = fc * (0.25 + 0.75 * shade[:, None])
    img[hit] = np.clip(col[fid[hit]], 0, 255).astype(np.uint8)
    return img, out["depth"]
