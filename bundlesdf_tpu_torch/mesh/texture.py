"""Texture baking: UV atlas + per-frame color projection.

Copy of `bundlesdf_tpu/mesh/texture.py` (host numpy, as there), which
replaces `mesh_texture_from_train_images` (nerf_runner.py:1468-1542): the
reference unwraps with xatlas, renders visibility with pyrender, finds
mesh-closest points with trimesh and scatters colors to UV with a CUDA
kernel. Here: a charted atlas in the xatlas spirit (xatlas itself is not in
the image) — greedy normal-coherent chart growing, per-chart planar
projection, shelf-packed into the square texture — with visibility +
barycentric UVs straight from the software rasterizer (mesh/render.py) and
numpy scatter-add accumulation.
"""
from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from bundlesdf_tpu_torch.mesh.core import Mesh
from bundlesdf_tpu_torch.mesh.render import rasterize
from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM


def unwrap_trivial_atlas(mesh: Mesh, tex_res: int = 1024, pad: float = 1.0):
    """Assign each face its own right triangle in a regular texture grid.
    Vertices are duplicated per face (3F vertices). Returns a new Mesh with
    `uv` in [0,1]^2 (v up, OBJ convention)."""
    F = len(mesh.faces)
    # 2 triangles per grid cell
    n_cells = (F + 1) // 2
    grid = int(np.ceil(np.sqrt(n_cells)))
    cell = tex_res / grid
    p = pad / tex_res

    verts = mesh.vertices[mesh.faces].reshape(-1, 3)  # (3F,3)
    faces = np.arange(3 * F, dtype=np.int64).reshape(F, 3)
    uv = np.zeros((3 * F, 2))
    cells = np.arange(F) // 2
    lower = np.arange(F) % 2 == 0
    cx = (cells % grid) * cell / tex_res
    cy = (cells // grid) * cell / tex_res
    s = cell / tex_res
    # lower-left triangle / upper-right triangle of the cell, with padding
    for i in range(F):
        x0, y0 = cx[i] + p, cy[i] + p
        x1, y1 = cx[i] + s - p, cy[i] + s - p
        if lower[i]:
            tri = [(x0, y0), (x1, y0), (x0, y1)]
        else:
            tri = [(x1, y1), (x0, y1), (x1, y0)]
        uv[3 * i:3 * i + 3] = tri
    return Mesh(verts, faces, uv=uv)


def _grow_charts(faces, face_normals, min_dot=0.75):
    """Partition faces into normal-coherent edge-connected charts.

    Greedy BFS from unassigned seeds: a face joins the chart when its
    normal agrees with the chart seed's normal (dot > @min_dot), which
    bounds projection distortion and keeps the per-chart planar map
    fold-free in practice (every face normal stays within acos(min_dot)
    of the projection axis). Returns a list of face-index arrays."""
    F = len(faces)
    edge_faces = defaultdict(list)
    for fi, tri in enumerate(faces):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edge_faces[(min(a, b), max(a, b))].append(fi)
    adj = [[] for _ in range(F)]
    for fs in edge_faces.values():
        for i in fs:
            for j in fs:
                if i != j:
                    adj[i].append(j)

    assigned = np.full(F, -1, np.int64)
    charts = []
    order = np.argsort(-np.abs(face_normals).max(axis=1))  # stable seeds
    for seed in order:
        if assigned[seed] >= 0:
            continue
        cid = len(charts)
        n0 = face_normals[seed]
        members = [seed]
        assigned[seed] = cid
        queue = [seed]
        while queue:
            f = queue.pop()
            for g in adj[f]:
                if assigned[g] < 0 and float(face_normals[g] @ n0) > min_dot:
                    assigned[g] = cid
                    members.append(g)
                    queue.append(g)
        charts.append(np.asarray(members, np.int64))
    return charts


def _project_chart(vertices, faces, chart_faces, normal):
    """Planar-project a chart's vertices onto the plane orthogonal to
    @normal. Returns (local vertex ids per face (C,3), 2D coords (Vc,2))."""
    vids = np.unique(faces[chart_faces].ravel())
    remap = np.full(len(vertices), -1, np.int64)
    remap[vids] = np.arange(len(vids))
    # orthonormal basis in the plane
    a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(normal, a)
    u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    pts = vertices[vids]
    uv = np.stack([pts @ u, pts @ v], axis=-1)
    uv -= uv.min(axis=0)
    return remap[faces[chart_faces]], uv, vids


def unwrap_charted_atlas(mesh: Mesh, tex_res: int = 1024, pad: int = 2,
                         min_dot: float = 0.75):
    """Charted UV unwrap (xatlas-equivalent role, ref nerf_runner.py:1470):
    grow normal-coherent charts, planar-project each, shelf-pack the chart
    rectangles into the [0,1]^2 atlas with @pad texels of gutter. Vertices
    are duplicated per chart (charts don't share UVs). Returns a new Mesh
    with `uv` (v-up, OBJ convention)."""
    fn = np.cross(
        mesh.vertices[mesh.faces[:, 1]] - mesh.vertices[mesh.faces[:, 0]],
        mesh.vertices[mesh.faces[:, 2]] - mesh.vertices[mesh.faces[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    charts = _grow_charts(mesh.faces, fn, min_dot=min_dot)

    projected = []  # (local_faces, uv2d, global_vids, w, h)
    for cf in charts:
        n = fn[cf].mean(axis=0)
        nn = np.linalg.norm(n)
        n = fn[cf[0]] if nn < 1e-6 else n / nn
        lf, uv2d, vids = _project_chart(mesh.vertices, mesh.faces, cf, n)
        w, h = uv2d.max(axis=0) if len(uv2d) else (0.0, 0.0)
        projected.append([lf, uv2d, vids, float(w), float(h)])

    # global scale: fill ~70% of the atlas area with chart bboxes, then
    # shrink until the shelf packing fits
    area = sum(max(p[3], 1e-12) * max(p[4], 1e-12) for p in projected)
    scale = tex_res * np.sqrt(0.7 / max(area, 1e-12))
    order = np.argsort([-projected[i][4] for i in range(len(projected))])
    for _ in range(40):
        # shelf packing at this scale (tallest-first rows)
        pos = {}
        x = y = shelf_h = pad
        ok = True
        for i in order:
            w = projected[i][3] * scale + 2 * pad
            h = projected[i][4] * scale + 2 * pad
            if w > tex_res or h > tex_res:
                ok = False
                break
            if x + w > tex_res:
                x = pad
                y += shelf_h
                shelf_h = 0
            if y + h > tex_res:
                ok = False
                break
            pos[i] = (x + pad, y + pad)
            x += w
            shelf_h = max(shelf_h, h)
        if ok:
            break
        scale *= 0.9
    else:
        raise RuntimeError("atlas packing failed")

    verts, faces, uvs = [], [], []
    base = 0
    for i, (lf, uv2d, vids, _, _) in enumerate(projected):
        px, py = pos[i]
        uvs.append((uv2d * scale + (px, py)) / tex_res)
        verts.append(mesh.vertices[vids])
        faces.append(lf + base)
        base += len(vids)
    out = Mesh(np.concatenate(verts), np.concatenate(faces),
               uv=np.concatenate(uvs))
    logging.info(f"charted atlas: {len(charts)} charts, scale {scale:.1f} "
                 f"texels/unit")
    return out


def bake_texture(mesh: Mesh, rgbs_raw, masks, glcam_in_obs, K,
                 pose_corrections=None, tex_res: int = 1024,
                 min_view_dot: float = 0.0):
    """Bake per-frame colors into a texture image.

    @mesh: in the SAME (normalized or real) space as @glcam_in_obs poses.
    @rgbs_raw: (F,H,W,3) uint8 full images; @masks: (F,H,W) bool/uint8.
    @glcam_in_obs: (F,4,4) GL cam-to-object. Returns textured Mesh (with
    .uv and .texture set).
    """
    tex_mesh = unwrap_charted_atlas(mesh, tex_res)
    Htex = Wtex = tex_res
    acc = np.zeros((Htex, Wtex, 3), np.float64)
    wacc = np.zeros((Htex, Wtex), np.float64)
    H, W = np.asarray(rgbs_raw[0]).shape[:2]

    fn = np.cross(
        tex_mesh.vertices[tex_mesh.faces[:, 1]] - tex_mesh.vertices[tex_mesh.faces[:, 0]],
        tex_mesh.vertices[tex_mesh.faces[:, 2]] - tex_mesh.vertices[tex_mesh.faces[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)

    for i in range(len(rgbs_raw)):
        tf = np.asarray(glcam_in_obs[i])
        if pose_corrections is not None:
            tf = np.asarray(pose_corrections[i]) @ tf
        cvcam_in_ob = tf @ np.linalg.inv(GLCAM_IN_CVCAM)
        ob_in_cam = np.linalg.inv(cvcam_in_ob)
        ras = rasterize(tex_mesh.vertices, tex_mesh.faces, K, ob_in_cam, H, W)
        fid = ras["face_id"]
        valid = (fid >= 0) & (np.asarray(masks[i]) > 0)
        if not valid.any():
            continue
        vs, us = np.nonzero(valid)
        f = fid[vs, us]
        b = ras["bary"][vs, us]  # (N,3)
        uv_face = tex_mesh.uv[tex_mesh.faces[f]]  # (N,3,2)
        uv = np.einsum("nc,ncd->nd", b, uv_face)  # (N,2) in [0,1]
        tx = np.clip(np.round(uv[:, 0] * (Wtex - 1)).astype(int), 0, Wtex - 1)
        ty = np.clip(np.round(uv[:, 1] * (Htex - 1)).astype(int), 0, Htex - 1)
        colors = np.asarray(rgbs_raw[i])[vs, us].astype(np.float64)
        # view-angle weight
        view = -(ob_in_cam[:3, :3] @ fn[f].T).T[:, 2]
        w = np.clip(view, min_view_dot, None)
        np.add.at(acc, (ty, tx), colors * w[:, None])
        np.add.at(wacc, (ty, tx), w)
        logging.debug(f"bake frame {i}: {valid.sum()} px")

    tex = np.zeros((Htex, Wtex, 3), np.uint8)
    got = wacc > 0
    tex[got] = np.clip(acc[got] / wacc[got][:, None], 0, 255).astype(np.uint8)
    # gutter dilation: bleed baked colors a few texels outward so bilinear
    # sampling across chart borders doesn't pick up background
    filled = got.copy()
    for _ in range(4):
        grow = np.zeros_like(filled)
        col = np.zeros((Htex, Wtex, 3), np.float64)
        cnt = np.zeros((Htex, Wtex), np.float64)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            src = np.roll(filled, (dy, dx), axis=(0, 1))
            c = np.roll(tex, (dy, dx), axis=(0, 1)).astype(np.float64)
            add = src & ~filled
            col[add] += c[add]
            cnt[add] += 1
            grow |= add
        has = cnt > 0
        tex[has] = np.clip(col[has] / cnt[has][:, None], 0, 255).astype(np.uint8)
        filled |= grow
    # fill far texels with a neutral gray for clean rendering
    tex[~filled] = 128
    # texture images use v-up: flip rows (ref nerf_runner.py:1539)
    tex_mesh.texture = tex[::-1].copy()
    return tex_mesh
