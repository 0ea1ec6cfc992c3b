"""Scene-bounds computation (ref `tool.py:18-132`): per-frame masked depth
clouds -> voxel downsample -> statistical outlier removal -> merge -> DBSCAN
biggest cluster -> center + scale to [-1,1] with sc_factor *= 0.9.

Copy of `bundlesdf_tpu/scene/bounds.py` (numpy + cKDTree), except that
`dbscan_labels` takes the place of sklearn's `DBSCAN`: the machine with the
card has no sklearn. It gives sklearn's labels (see its docstring). Each
call of `compute_scene_bounds`, `compute_scene_bounds_frame` and
`find_biggest_cluster` is the span `scene.bounds` (`utils/profiling.py`).
"""
from __future__ import annotations

import logging

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from bundlesdf_tpu_torch.utils.common import GLCAM_IN_CVCAM, depth2xyzmap
from bundlesdf_tpu_torch.utils.profiling import spanned


def voxel_downsample(pts, voxel, colors=None):
    """Mean-of-voxel downsampling (open3d voxel_down_sample equivalent)."""
    if len(pts) == 0:
        return (pts, colors) if colors is not None else pts
    keys = np.floor(pts / voxel).astype(np.int64)
    _, idx, inv = np.unique(keys, axis=0, return_index=True,
                            return_inverse=True)
    n = idx.shape[0]
    sums = np.zeros((n, 3))
    cnts = np.zeros(n)
    np.add.at(sums, inv, pts)
    np.add.at(cnts, inv, 1)
    out = sums / cnts[:, None]
    if colors is not None:
        csums = np.zeros((n, 3))
        np.add.at(csums, inv, colors)
        return out, csums / cnts[:, None]
    return out


def remove_statistical_outliers(pts, nb_neighbors=30, std_ratio=2.0,
                                colors=None):
    if len(pts) <= nb_neighbors:
        return (pts, colors) if colors is not None else pts
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=nb_neighbors + 1, workers=-1)
    mean_d = d[:, 1:].mean(axis=1)
    keep = mean_d <= mean_d.mean() + std_ratio * mean_d.std()
    if colors is not None:
        return pts[keep], colors[keep]
    return pts[keep]


def dbscan_labels(pts, eps, min_samples):
    """DBSCAN cluster labels, equal to
    `sklearn.cluster.DBSCAN(eps, min_samples).fit(pts).labels_`:
    - a core point has at least @min_samples points within @eps (distance
      <= eps), itself included;
    - core points within eps of each other share a cluster; clusters are
      numbered in the order of their lowest core-point index (sklearn's
      scan starts a cluster at each unlabelled core point, in index order);
    - a border point (not core, a core point within eps) takes the first
      cluster that reaches it in that scan: the lowest label among its core
      neighbours;
    - every other point is noise, -1."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    tree = cKDTree(pts)
    counts = tree.query_ball_point(pts, eps, return_length=True, workers=-1)
    core = counts >= min_samples
    pairs = tree.query_pairs(eps, output_type="ndarray")
    i, j = (pairs[:, 0], pairs[:, 1]) if len(pairs) else (
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    cc = core[i] & core[j]
    adj = coo_matrix((np.ones(int(cc.sum())), (i[cc], j[cc])), shape=(n, n))
    _, comp = connected_components(adj, directed=False)
    # number the components holding core points by their lowest core index
    core_idx = np.nonzero(core)[0]
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp[core_idx], core_idx)
    used = np.nonzero(first < n)[0]
    rank = np.full(comp.max() + 1, -1, np.int64)
    rank[used[np.argsort(first[used], kind="stable")]] = np.arange(len(used))
    labels[core_idx] = rank[comp[core_idx]]
    # border points: the lowest label among their core neighbours
    best = np.full(n, n, np.int64)
    for a, b in ((i, j), (j, i)):
        sel = core[a] & ~core[b]
        np.minimum.at(best, b[sel], labels[a[sel]])
    border = best < n
    labels[border] = best[border]
    return labels


@spanned("scene.bounds")
def find_biggest_cluster(pts, eps=0.06, min_samples=1):
    """Ref tool.py:18-25."""
    labels = dbscan_labels(pts, eps, min_samples)
    ids, cnts = np.unique(labels, return_counts=True)
    best = ids[cnts.argmax()]
    keep = labels == best
    return pts[keep], keep


def compute_translation_scales(pts, max_dim=2, cluster=True, eps=0.06,
                               min_samples=1):
    """Ref tool.py:28-39: center on the biggest cluster's bbox, scale the
    longest side to max_dim with a 0.9 safety margin."""
    if cluster:
        # unspanned: compute_scene_bounds' span holds this call
        pts, keep = find_biggest_cluster.__wrapped__(pts, eps, min_samples)
    else:
        keep = np.ones(len(pts), bool)
    max_xyz = pts.max(axis=0)
    min_xyz = pts.min(axis=0)
    center = (max_xyz + min_xyz) / 2
    sc_factor = max_dim / (max_xyz - min_xyz).max() * 0.9
    return -center, sc_factor, keep


@spanned("scene.bounds")
def compute_scene_bounds_frame(depth, mask, glcam_in_world, K):
    """Single-frame worker (ref compute_scene_bounds_worker tool.py:42-64):
    masked depth cloud -> voxel downsample -> outlier removal -> world frame.
    Returns (N,3) world points or None."""
    depth = np.asarray(depth, np.float64)
    xyz = depth2xyzmap(depth, K)
    valid = depth >= 0.1
    if mask is not None:
        valid = valid & (np.asarray(mask) > 0)
    pts = xyz[valid].reshape(-1, 3)
    if len(pts) == 0:
        return None
    pts = voxel_downsample(pts, 0.01)
    pts = remove_statistical_outliers(pts, nb_neighbors=30, std_ratio=2.0)
    cam_in_world = np.asarray(glcam_in_world) @ GLCAM_IN_CVCAM
    return pts @ cam_in_world[:3, :3].T + cam_in_world[:3, 3]


@spanned("scene.bounds")
def compute_scene_bounds(rgbs, depths, masks, glcam_in_worlds, K,
                         use_mask=True, cluster=True, translation_cvcam=None,
                         sc_factor=None, eps=0.06, min_samples=1):
    """Ref tool.py:67-132 (in-memory variant). @glcam_in_worlds: (F,4,4) GL
    cam-to-world. Returns (sc_factor, translation_cvcam, pcd_real_scale
    (N,3), pcd_normalized (N,3))."""
    all_pts = []
    for i in range(len(depths)):
        depth = np.asarray(depths[i], np.float64)
        xyz = depth2xyzmap(depth, K)
        valid = depth >= 0.1
        if use_mask and masks is not None:
            valid = valid & (np.asarray(masks[i]) > 0)
        pts = xyz[valid].reshape(-1, 3)
        if len(pts) == 0:
            continue
        pts = voxel_downsample(pts, 0.01)
        pts = remove_statistical_outliers(pts, nb_neighbors=30, std_ratio=2.0)
        cam_in_world = np.asarray(glcam_in_worlds[i]) @ GLCAM_IN_CVCAM
        pts = pts @ cam_in_world[:3, :3].T + cam_in_world[:3, 3]
        all_pts.append(pts)
    if not all_pts:
        raise ValueError("no valid points for scene bounds")
    pts = np.concatenate(all_pts, axis=0)
    pts = voxel_downsample(pts, eps / 5)

    def make_tf(t, s):
        tf = np.eye(4)
        tf[:3, 3] = t
        tf1 = np.eye(4)
        tf1[:3, :3] *= s
        return tf1 @ tf

    if translation_cvcam is None:
        translation_cvcam, sc_factor, keep = compute_translation_scales(
            pts, cluster=cluster, eps=eps, min_samples=min_samples)
    else:
        tf = make_tf(translation_cvcam, sc_factor)
        tmp = pts @ tf[:3, :3].T + tf[:3, 3]
        keep = (np.abs(tmp) < 1).all(axis=-1)
    logging.info(f"scene bounds: translation={translation_cvcam}, "
                 f"sc_factor={sc_factor:.4f}")
    tf = make_tf(translation_cvcam, sc_factor)
    pcd_real = pts[keep]
    pcd_norm = pcd_real @ tf[:3, :3].T + tf[:3, 3]
    return sc_factor, translation_cvcam, pcd_real, pcd_norm
