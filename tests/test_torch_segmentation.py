"""The port's segmenter (`bundlesdf_tpu_torch/utils/segmentation.py`)
against the JAX package's, on files the tests write: `load_ply_vertices`
on ascii and binary little-endian PLYs with extra vertex properties and a
face element; `Segmenter.run` on grey and colour mask PNGs with and
without a background cloud (the cKDTree subtraction), a missing mask file
and a malformed cloud; and `run_one_video(use_segmenter=True)` of both
drivers feeding the tracker the same masks."""
import os

import cv2
import numpy as np
import pytest

from synthetic import cube_orbit_sequence

import run_custom as j_run
from bundlesdf_tpu.utils import segmentation as jseg
from bundlesdf_tpu_torch import run_custom as t_run
from bundlesdf_tpu_torch.utils import segmentation as tseg
from bundlesdf_tpu_torch.utils.png import write_png


def _write_ply(path, pts, fmt):
    """Vertices x y z, normals, uchar colours, then one face."""
    n = len(pts)
    rng = np.random.default_rng(1)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    head = (f"ply\nformat {fmt} 1.0\ncomment written by a test\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "element face 1\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if fmt == "ascii":
            for p, q, c in zip(pts, nrm, rgb):
                f.write((" ".join(f"{v:.6f}" for v in (*p, *q))
                         + " " + " ".join(str(int(v)) for v in c)
                         + "\n").encode("ascii"))
            f.write(b"3 0 1 2\n")
        else:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                           ("red", "u1"), ("green", "u1"), ("blue", "u1")])
            rec = np.zeros(n, dt)
            for k, name in enumerate("xyz"):
                rec[name] = pts[:, k]
            for k, name in enumerate(("nx", "ny", "nz")):
                rec[name] = nrm[:, k]
            for k, name in enumerate(("red", "green", "blue")):
                rec[name] = rgb[:, k]
            f.write(rec.tobytes())
            f.write(np.array([3], np.uint8).tobytes()
                    + np.array([0, 1, 2], "<i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_load_ply_vertices_equal_jax(tmp_path, fmt):
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.ply")
    _write_ply(path, pts, fmt)
    ours, ref = tseg.load_ply_vertices(path), jseg.load_ply_vertices(path)
    assert ours.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours, pts, atol=1e-6)


def _scene(tmp_path, H=48, W=64):
    """A depth map (a plane at 0.5 m with a box at 0.4 m), its K, grey and
    colour masks covering both, and a background cloud sampled on the
    plane."""
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
    depth = np.full((H, W), 0.5, np.float32)
    depth[10:30, 20:40] = 0.4
    vs, us = np.mgrid[:H, :W]
    plane = np.stack([(us - K[0, 2]) * 0.5 / K[0, 0],
                      (vs - K[1, 2]) * 0.5 / K[1, 1],
                      np.full((H, W), 0.5)], -1).reshape(-1, 3)
    _write_ply(str(tmp_path / "bg.ply"), plane[::3].astype(np.float32),
               "binary_little_endian")
    mask = np.zeros((H, W), np.uint8)
    mask[5:40, 10:55] = 255
    cv2.imwrite(str(tmp_path / "grey.png"), mask)
    colour = np.stack([mask, mask // 2, np.zeros_like(mask)], -1)
    cv2.imwrite(str(tmp_path / "bgr.png"), colour)
    write_png(str(tmp_path / "rgb.png"), colour)
    return depth, K


@pytest.mark.parametrize("bg", ["none", "cloud", "malformed"])
def test_segmenter_equals_jax(tmp_path, bg):
    depth, K = _scene(tmp_path)
    if bg == "malformed":
        with open(tmp_path / "bad.ply", "wb") as f:
            f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 9"
                    b"\nproperty float x\nend_header\n\x00")
    cfg = {"segmentation": {"bg_dir": {"none": "", "cloud": str(
        tmp_path / "bg.ply"), "malformed": str(tmp_path / "bad.ply")}[bg],
        "bg_dist": 0.01}}
    ours, ref = tseg.Segmenter(cfg), jseg.Segmenter(cfg)
    assert (ours.bg_pts is None) == (ref.bg_pts is None) == (bg != "cloud")
    for name in ("grey.png", "bgr.png", "rgb.png"):
        f = str(tmp_path / name)
        a, b = ours.run(f), ref.run(f)
        np.testing.assert_array_equal(a, b, err_msg=name)
        a, b = ours.run(f, depth=depth, K=K), ref.run(f, depth=depth, K=K)
        np.testing.assert_array_equal(a, b, err_msg=name)
        if bg == "cloud":
            # the plane is subtracted, the box in front of it kept
            assert a[20, 30] > 0 and a[35, 15] == 0
    missing = str(tmp_path / "none.png")
    assert ours.run(missing) is None and ref.run(missing) is None


def test_run_one_video_use_segmenter_feeds_the_tracker_as_jax(tmp_path,
                                                              monkeypatch):
    """Both drivers with --use_segmenter and the tracker replaced by a
    recorder: the masks read through the segmenter, resized to the
    reader's 480 px and eroded, reach `BundleSdf.run` equal."""
    root = str(tmp_path / "video")
    seq = cube_orbit_sequence(n_frames=2, H=60, W=80)
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
    np.savetxt(f"{root}/cam_K.txt", seq["K"])
    for i, id_str in enumerate(seq["id_strs"]):
        cv2.imwrite(f"{root}/rgb/{id_str}.png", seq["colors"][i][..., ::-1])
        cv2.imwrite(f"{root}/depth/{id_str}.png",
                    (seq["depths"][i] * 1000).astype(np.uint16))
        cv2.imwrite(f"{root}/masks/{id_str}.png",
                    seq["masks"][i].astype(np.uint8) * 255)
    seen = {}
    for name, mod in (("jax", j_run), ("port", t_run)):
        masks = seen[name] = []

        class Recorder:
            def __init__(self, **kw):
                pass

            def run(self, color, depth, K, id_str, mask=None, occ_mask=None,
                    pose_in_model=None):
                masks.append(mask)

            def on_finish(self):
                pass

        monkeypatch.setattr(mod, "BundleSdf", Recorder)
        mod.run_one_video(root, str(tmp_path / name), use_segmenter=True,
                          skip_refine=True)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for a, b in zip(seen["port"], seen["jax"]):
        assert a.shape == (480, 640) and a.max() == 255
        np.testing.assert_array_equal(a, b)
