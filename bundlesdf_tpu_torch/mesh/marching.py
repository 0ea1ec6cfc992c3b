"""Iso-surface extraction by vectorized marching tetrahedra.

Copy of `bundlesdf_tpu/mesh/marching.py`, which replaces skimage
`measure.marching_cubes` in the reference's `extract_mesh`
(`nerf_runner.py:1351-1409`). Marching tetrahedra is chosen over classic
marching cubes because its case tables derive from first principles (no
256-entry lookup data), it has no ambiguous cases, and it vectorizes to a
handful of numpy gathers — extraction happens off the training hot path, so
host numpy is the right tool.

Each cell of the voxel grid is split into 6 tetrahedra sharing the main
diagonal; each tetrahedron contributes 0, 1 or 2 triangles with vertices
linearly interpolated along its edges at the iso level.
"""
from __future__ import annotations

import numpy as np

# 6 tetrahedra per cube, as corner indices of the unit cube (bit order zyx:
# corner c = (x,y,z) with x=c&1, y=(c>>1)&1, z=(c>>2)&1). All share the
# 0-7 main diagonal.
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], dtype=np.int64)

_CUBE_OFFSETS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                          for c in range(8)], dtype=np.int64)

# The 6 edges of a tetrahedron as (corner_a, corner_b) local indices.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      dtype=np.int64)

def _build_case_table():
    """Triangulation per 4-bit "inside" case, derived from first principles.
    |inside|=1 or 3: the 3 cut edges form one triangle. |inside|=2: the 4
    cut edges form a quad whose cyclic order (a,c),(a,d),(b,d),(b,c) —
    consecutive edges share a tet corner — splits into 2 triangles. Winding
    is fixed afterwards using the field gradient, so only connectivity
    matters here."""
    edge_id = {(min(a, b), max(a, b)): i for i, (a, b) in enumerate(_TET_EDGES)}
    table = {}
    for case in range(1, 15):
        inside = [c for c in range(4) if case >> c & 1]
        outside = [c for c in range(4) if not case >> c & 1]
        if len(inside) in (1, 3):
            one, rest = ((inside[0], outside) if len(inside) == 1
                         else (outside[0], inside))
            edges = [edge_id[(min(one, o), max(one, o))] for o in rest]
            table[case] = [edges]
        else:
            a, b = inside
            c, d = outside
            quad = [edge_id[(min(a, c), max(a, c))],
                    edge_id[(min(a, d), max(a, d))],
                    edge_id[(min(b, d), max(b, d))],
                    edge_id[(min(b, c), max(b, c))]]
            table[case] = [[quad[0], quad[1], quad[2]],
                           [quad[0], quad[2], quad[3]]]
    return table


_CASE_TRIS = _build_case_table()


def marching_tetrahedra(field: np.ndarray, isolevel: float = 0.0):
    """Extract the `field == isolevel` surface.

    @field: (Nx,Ny,Nz) scalar grid (e.g. SDF). Values below `isolevel`
    are "inside".
    Returns (vertices (V,3) float64 in index coordinates, faces (F,3) int64),
    with duplicate vertices merged and triangles wound so normals point
    toward increasing field (outward for an SDF).
    """
    field = np.asarray(field, np.float64)
    nx, ny, nz = field.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # native C++ path (native/src/marching_tet.cpp) when built; winding is
    # fixed below either way
    from bundlesdf_tpu_torch.native import marching_tetrahedra_native
    nat = marching_tetrahedra_native(field, isolevel)
    marching_tetrahedra.last_path = "numpy" if nat is None else "native"
    if nat is not None:
        verts, faces = nat
        if len(faces) == 0:
            return verts, faces
        return _fix_winding(field, verts, faces, nx, ny, nz)

    # cells whose 8 corners straddle the isolevel
    inside = field < isolevel
    c = inside[:-1, :-1, :-1]
    any_in = np.zeros_like(c)
    all_in = np.ones_like(c)
    for o in _CUBE_OFFSETS:
        blk = inside[o[0]:nx - 1 + o[0], o[1]:ny - 1 + o[1], o[2]:nz - 1 + o[2]]
        any_in |= blk
        all_in &= blk
    active = np.argwhere(any_in & ~all_in)  # (M,3) cell origins
    if len(active) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # corner positions + values for active cells: (M,8)
    corner_idx = active[:, None, :] + _CUBE_OFFSETS[None]  # (M,8,3)
    vals = field[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    tri_pts = []
    for tet in _TETS:
        tv = vals[:, tet]                      # (M,4)
        tp = corner_idx[:, tet, :].astype(np.float64)  # (M,4,3)
        case = ((tv[:, 0] < isolevel).astype(np.int64)
                | ((tv[:, 1] < isolevel) << 1)
                | ((tv[:, 2] < isolevel) << 2)
                | ((tv[:, 3] < isolevel) << 3))
        for code, tris in _CASE_TRIS.items():
            sel = np.nonzero(case == code)[0]
            if len(sel) == 0:
                continue
            v = tv[sel]
            p = tp[sel]
            # interpolated point on each tet edge
            ea, eb = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
            va, vb = v[:, ea], v[:, eb]                    # (S,6)
            denom = vb - va
            t = np.where(np.abs(denom) < 1e-12, 0.5,
                         (isolevel - va) / np.where(np.abs(denom) < 1e-12, 1.0,
                                                    denom))
            t = np.clip(t, 0.0, 1.0)
            ep = p[:, ea, :] + t[..., None] * (p[:, eb, :] - p[:, ea, :])  # (S,6,3)
            for tri in tris:
                tri_pts.append(ep[:, tri, :])  # (S,3,3)

    tris = np.concatenate(tri_pts, axis=0)  # (T,3,3)

    # merge duplicate vertices (edges shared between tets/cells)
    flat = tris.reshape(-1, 3)
    key = np.round(flat * 1e6).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    # drop degenerate triangles
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    return _fix_winding(field, verts, faces, nx, ny, nz)


# which path the last call marched: "native" or "numpy" (chip_smoke.py
# prints it)
marching_tetrahedra.last_path = None


def _fix_winding(field, verts, faces, nx, ny, nz):
    """Orient triangles so normals point toward increasing field (outward
    for an SDF)."""
    grad = _grid_gradient(field)
    centers = verts[faces].mean(axis=1)
    ci = np.clip(np.round(centers).astype(np.int64), 0,
                 np.array([nx - 1, ny - 1, nz - 1]))
    g = grad[ci[:, 0], ci[:, 1], ci[:, 2]]
    n = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                 verts[faces[:, 2]] - verts[faces[:, 0]])
    flip = np.sum(n * g, axis=-1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def _grid_gradient(field):
    gx, gy, gz = np.gradient(field)
    return np.stack([gx, gy, gz], axis=-1)
