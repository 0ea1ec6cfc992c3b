"""Minimal triangle-mesh container + repair ops + OBJ/PLY I/O.

Copy of `bundlesdf_tpu/mesh/core.py`, which replaces the trimesh usage in
the reference (`Utils.py:278-298` trimesh_split/trimesh_clean, mesh exports
in `nerf_runner.py` / `bundlesdf.py:747-766`). Host-side numpy and scipy
(a textured mesh's image goes through `utils/png.py`); meshes are small
artifacts, not hot-path data.
"""
from __future__ import annotations

import os

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from bundlesdf_tpu_torch.utils.png import write_png


class Mesh:
    """Vertices (V,3) float64, faces (F,3) int64, optional per-vertex colors
    (V,3) uint8 and uv (V,2)."""

    def __init__(self, vertices, faces, vertex_colors=None, uv=None,
                 texture=None):
        self.vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int64).reshape(-1, 3)
        self.vertex_colors = (None if vertex_colors is None
                              else np.asarray(vertex_colors))
        self.uv = None if uv is None else np.asarray(uv)
        self.texture = None if texture is None else np.asarray(texture)

    # -- geometry ----------------------------------------------------------

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy(),
                    None if self.vertex_colors is None else self.vertex_colors.copy(),
                    None if self.uv is None else self.uv.copy(),
                    None if self.texture is None else self.texture.copy())

    def apply_transform(self, T) -> "Mesh":
        T = np.asarray(T)
        self.vertices = self.vertices @ T[:3, :3].T + T[:3, 3]
        return self

    def vertex_normals(self):
        fn = np.cross(self.vertices[self.faces[:, 1]] - self.vertices[self.faces[:, 0]],
                      self.vertices[self.faces[:, 2]] - self.vertices[self.faces[:, 0]])
        vn = np.zeros_like(self.vertices)
        for i in range(3):
            np.add.at(vn, self.faces[:, i], fn)
        n = np.linalg.norm(vn, axis=-1, keepdims=True)
        return vn / np.maximum(n, 1e-12)

    def merge_vertices(self, tol=1e-6) -> "Mesh":
        """Weld duplicate vertices (ref mesh.merge_vertices, bundlesdf.py:749)."""
        key = np.round(self.vertices / tol).astype(np.int64)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        self.vertices = self.vertices[first]
        if self.vertex_colors is not None:
            self.vertex_colors = self.vertex_colors[first]
        if self.uv is not None:
            self.uv = self.uv[first]
        self.faces = inv[self.faces]
        ok = ((self.faces[:, 0] != self.faces[:, 1])
              & (self.faces[:, 1] != self.faces[:, 2])
              & (self.faces[:, 0] != self.faces[:, 2]))
        self.faces = self.faces[ok]
        return self

    def split_components(self):
        """Connected components as separate meshes (ref trimesh_split
        Utils.py:278-285)."""
        V = len(self.vertices)
        e = np.concatenate([self.faces[:, [0, 1]], self.faces[:, [1, 2]],
                            self.faces[:, [2, 0]]], axis=0)
        adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
        n_comp, labels = connected_components(adj, directed=False)
        out = []
        for ci in range(n_comp):
            vm = labels == ci
            if vm.sum() < 3:
                continue
            remap = -np.ones(V, np.int64)
            remap[vm] = np.arange(vm.sum())
            fm = vm[self.faces].all(axis=1)
            if fm.sum() == 0:
                continue
            out.append(Mesh(
                self.vertices[vm], remap[self.faces[fm]],
                None if self.vertex_colors is None else self.vertex_colors[vm]))
        return out

    def keep_biggest_component(self) -> "Mesh":
        comps = self.split_components()
        if not comps:
            return self
        best = max(comps, key=lambda m: len(m.vertices))
        self.vertices, self.faces = best.vertices, best.faces
        self.vertex_colors = best.vertex_colors
        return self

    def remove_vertices_by_mask(self, keep_mask) -> "Mesh":
        keep_mask = np.asarray(keep_mask, bool)
        remap = -np.ones(len(self.vertices), np.int64)
        remap[keep_mask] = np.arange(keep_mask.sum())
        fm = keep_mask[self.faces].all(axis=1)
        self.vertices = self.vertices[keep_mask]
        if self.vertex_colors is not None:
            self.vertex_colors = self.vertex_colors[keep_mask]
        if self.uv is not None:
            self.uv = self.uv[keep_mask]
        self.faces = remap[self.faces[fm]]
        return self

    def smooth_laplacian(self, lamb=0.5, iterations=3) -> "Mesh":
        """Umbrella-operator Laplacian smoothing (trimesh
        filter_laplacian equivalent; ref run_custom.py:186)."""
        V = len(self.vertices)
        e = np.concatenate([self.faces[:, [0, 1]], self.faces[:, [1, 2]],
                            self.faces[:, [2, 0]]], axis=0)
        e = np.concatenate([e, e[:, ::-1]], axis=0)
        deg = np.zeros(V)
        np.add.at(deg, e[:, 0], 1.0)
        for _ in range(iterations):
            nb_sum = np.zeros_like(self.vertices)
            np.add.at(nb_sum, e[:, 0], self.vertices[e[:, 1]])
            mean = nb_sum / np.maximum(deg[:, None], 1.0)
            self.vertices = self.vertices + lamb * (mean - self.vertices)
        return self

    def oriented_bounds(self):
        """PCA oriented bounding box (trimesh.bounds.oriented_bounds
        equivalent): returns (to_origin (4,4), extents (3,)) such that
        transforming the mesh by to_origin centers it axis-aligned."""
        pts = self.vertices
        center = pts.mean(axis=0)
        cov = np.cov((pts - center).T)
        _, vecs = np.linalg.eigh(cov)
        R = vecs.T
        if np.linalg.det(R) < 0:
            R[2] *= -1
        local = (pts - center) @ R.T
        mn, mx = local.min(axis=0), local.max(axis=0)
        extents = mx - mn
        mid = (mn + mx) / 2
        to_origin = np.eye(4)
        to_origin[:3, :3] = R
        to_origin[:3, 3] = -(R @ center) - mid
        return to_origin, extents

    def sample_surface(self, n, seed=0):
        """Uniform area-weighted surface samples (ref trimesh.sample used in
        benchmark_ho3d.py:119)."""
        rng = np.random.default_rng(seed)
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        p = area / max(area.sum(), 1e-12)
        fi = rng.choice(len(self.faces), size=n, p=p)
        r1 = np.sqrt(rng.random(n))
        r2 = rng.random(n)
        return ((1 - r1)[:, None] * v0[fi] + (r1 * (1 - r2))[:, None] * v1[fi]
                + (r1 * r2)[:, None] * v2[fi])

    # -- I/O ---------------------------------------------------------------

    def export(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if path.endswith(".obj"):
            self._export_obj(path)
        elif path.endswith(".ply"):
            self._export_ply(path)
        else:
            raise ValueError(f"unsupported mesh format: {path}")

    def _export_obj(self, path):
        lines = []
        has_uv = self.uv is not None
        if has_uv and self.texture is not None:
            mtl_path = os.path.splitext(path)[0] + ".mtl"
            tex_path = os.path.splitext(path)[0] + ".png"
            write_png(tex_path, np.asarray(self.texture, np.uint8))
            with open(mtl_path, "w") as f:
                f.write("newmtl material0\nKa 1 1 1\nKd 1 1 1\n"
                        f"map_Kd {os.path.basename(tex_path)}\n")
            lines.append(f"mtllib {os.path.basename(mtl_path)}")
            lines.append("usemtl material0")
        for i, v in enumerate(self.vertices):
            if self.vertex_colors is not None:
                c = np.asarray(self.vertex_colors[i], np.float64)
                if c.max() > 1.0:
                    c = c / 255.0
                lines.append(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}")
            else:
                lines.append(f"v {v[0]} {v[1]} {v[2]}")
        if has_uv:
            for t in self.uv:
                lines.append(f"vt {t[0]} {t[1]}")
            for f0 in self.faces + 1:
                lines.append(f"f {f0[0]}/{f0[0]} {f0[1]}/{f0[1]} {f0[2]}/{f0[2]}")
        else:
            for f0 in self.faces + 1:
                lines.append(f"f {f0[0]} {f0[1]} {f0[2]}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def _export_ply(self, path):
        has_c = self.vertex_colors is not None
        with open(path, "wb") as f:
            hdr = ["ply", "format binary_little_endian 1.0",
                   f"element vertex {len(self.vertices)}",
                   "property float x", "property float y", "property float z"]
            if has_c:
                hdr += ["property uchar red", "property uchar green",
                        "property uchar blue"]
            hdr += [f"element face {len(self.faces)}",
                    "property list uchar int vertex_indices", "end_header"]
            f.write(("\n".join(hdr) + "\n").encode())
            if has_c:
                vc = self.vertex_colors
                if vc.dtype != np.uint8:
                    vc = np.clip(vc * (255.0 if vc.max() <= 1.0 else 1.0),
                                 0, 255).astype(np.uint8)
                dt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                arr = np.empty(len(self.vertices), dt)
                arr["xyz"] = self.vertices.astype(np.float32)
                arr["rgb"] = vc
            else:
                dt = np.dtype([("xyz", np.float32, 3)])
                arr = np.empty(len(self.vertices), dt)
                arr["xyz"] = self.vertices.astype(np.float32)
            f.write(arr.tobytes())
            fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
            farr = np.empty(len(self.faces), fdt)
            farr["n"] = 3
            farr["idx"] = self.faces.astype(np.int32)
            f.write(farr.tobytes())

    @staticmethod
    def load(path: str) -> "Mesh":
        if path.endswith(".obj"):
            return Mesh._load_obj(path)
        if path.endswith(".ply"):
            return Mesh._load_ply(path)
        raise ValueError(f"unsupported mesh format: {path}")

    @staticmethod
    def _load_obj(path):
        verts, faces, colors = [], [], []
        with open(path) as f:
            for line in f:
                t = line.split()
                if not t:
                    continue
                if t[0] == "v":
                    verts.append([float(x) for x in t[1:4]])
                    if len(t) >= 7:
                        colors.append([float(x) for x in t[4:7]])
                elif t[0] == "f":
                    idx = [int(x.split("/")[0]) - 1 for x in t[1:4]]
                    faces.append(idx)
        vc = np.array(colors) if len(colors) == len(verts) and colors else None
        return Mesh(np.array(verts), np.array(faces), vc)

    @staticmethod
    def _load_ply(path):
        with open(path, "rb") as f:
            n_v = n_f = 0
            props = []
            fmt = "binary_little_endian"
            while True:
                line = f.readline().decode().strip()
                if line.startswith("format"):
                    fmt = line.split()[1]
                elif line.startswith("element vertex"):
                    n_v = int(line.split()[-1])
                    cur = "v"
                elif line.startswith("element face"):
                    n_f = int(line.split()[-1])
                    cur = "f"
                elif line.startswith("property") and cur == "v":
                    props.append(line.split()[-1])
                elif line == "end_header":
                    break
            if fmt == "ascii":
                verts, colors = [], []
                for _ in range(n_v):
                    t = f.readline().decode().split()
                    verts.append([float(x) for x in t[:3]])
                    if len(props) >= 6:
                        colors.append([float(x) for x in t[3:6]])
                faces = []
                for _ in range(n_f):
                    t = f.readline().decode().split()
                    faces.append([int(x) for x in t[1:4]])
                vc = np.array(colors, np.uint8) if colors else None
                return Mesh(np.array(verts), np.array(faces), vc)
            # binary little endian
            fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
            has_c = "red" in props
            has_n = "nx" in props
            if has_n:
                fields += [("nx", np.float32), ("ny", np.float32),
                           ("nz", np.float32)]
            if has_c:
                fields += [("red", np.uint8), ("green", np.uint8),
                           ("blue", np.uint8)]
                if "alpha" in props:
                    fields += [("alpha", np.uint8)]
            dt = np.dtype(fields)
            arr = np.frombuffer(f.read(n_v * dt.itemsize), dt)
            verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float64)
            vc = (np.stack([arr["red"], arr["green"], arr["blue"]], -1)
                  if has_c else None)
            fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
            farr = np.frombuffer(f.read(n_f * fdt.itemsize), fdt)
            return Mesh(verts, farr["idx"].astype(np.int64), vc)
