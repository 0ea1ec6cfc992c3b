"""The port's entry scripts (`bundlesdf_tpu_torch/run_custom.py`,
`datasets/readers.py`) against the JAX package's (`run_custom.py`,
`bundlesdf_tpu/datasets/readers.py`): the configs, the reader's arrays,
the frames `run_one_video` feeds the tracker (erosion included), the
`postprocess_mesh` meshes and the `draw_pose` images are equal exactly."""
import math
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

import run_custom as j_run
from bundlesdf_tpu.datasets import YcbineoatReader as JReader
from bundlesdf_tpu_torch import run_custom as t_run
from bundlesdf_tpu_torch.config import dump_config, load_yaml
from bundlesdf_tpu_torch.datasets import YcbineoatReader
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher
from bundlesdf_tpu_torch.mesh import Mesh
from bundlesdf_tpu_torch.utils.png import read_png


def test_make_configs_equal_jax(tmp_path):
    for level in (0, 2):
        assert t_run.make_configs(str(tmp_path), level) == \
            j_run.make_configs(str(tmp_path), level)


def _dump_video(root, n=3, H=60, W=80, hands=False):
    """A YCBInEOAT-layout folder written with cv2 (tests/test_readers.py's
    layout; RGBA color, 3-channel masks and hand masks when @hands)."""
    seq = cube_orbit_sequence(n_frames=n, H=H, W=W)
    subs = ["rgb", "depth", "masks", "annotated_poses"]
    subs += ["masks_hand"] if hands else []
    for sub in subs:
        os.makedirs(f"{root}/{sub}", exist_ok=True)
    np.savetxt(f"{root}/cam_K.txt", seq["K"])
    for i, id_str in enumerate(seq["id_strs"]):
        bgr = seq["colors"][i][..., ::-1]
        if hands:
            bgr = np.concatenate([bgr, np.full((H, W, 1), 255, np.uint8)], -1)
        cv2.imwrite(f"{root}/rgb/{id_str}.png", bgr)
        cv2.imwrite(f"{root}/depth/{id_str}.png",
                    (seq["depths"][i] * 1000).astype(np.uint16))
        m = seq["masks"][i].astype(np.uint8) * 255
        cv2.imwrite(f"{root}/masks/{id_str}.png",
                    np.stack([m] * 3, -1) if hands else m)
        if hands:
            cv2.imwrite(f"{root}/masks_hand/{id_str}.png", m[::-1].copy())
        np.savetxt(f"{root}/annotated_poses/{id_str}.txt",
                   np.linalg.inv(seq["cam_in_obs"][i]))
    return seq


@pytest.mark.parametrize("hands", [False, True])
@pytest.mark.parametrize("kw", [{}, {"shorter_side": 45},
                                {"downscale": 0.37}])
def test_ycbineoat_reader_equals_jax(tmp_path, hands, kw):
    d = str(tmp_path / "vid")
    _dump_video(d, hands=hands)
    t, j = YcbineoatReader(d, **kw), JReader(d, **kw)
    assert (t.H, t.W, t.id_strs, len(t)) == (j.H, j.W, j.id_strs, len(j))
    np.testing.assert_array_equal(t.K, j.K)
    for i in range(len(j)):
        for get in ("get_color", "get_depth", "get_mask", "get_xyz_map",
                    "get_occ_mask", "get_gt_pose"):
            a, b = getattr(t, get)(i), getattr(j, get)(i)
            assert a.dtype == b.dtype, get
            np.testing.assert_array_equal(a, b, err_msg=get)
    os.remove(t.color_files[0].replace("rgb", "masks"))
    assert t.get_mask(0) is None and j.get_mask(0) is None


@pytest.mark.parametrize("k", [3, 4])
def test_erode_mask_equals_cv2(k):
    m = (np.random.default_rng(k).random((31, 40)) > 0.3).astype(np.uint8)
    m[0, :] = 1
    np.testing.assert_array_equal(t_run.erode_mask(m, k),
                                  cv2.erode(m, np.ones((k, k), np.uint8)))


def test_run_one_video_feeds_the_tracker_as_jax(tmp_path, monkeypatch):
    """Both entry points over one video with the tracker and the refine
    replaced by recorders: the same frames, masks (eroded), occluder masks,
    K and ids reach `BundleSdf.run`, and the same config files are
    dumped."""
    video = str(tmp_path / "video")
    _dump_video(video, hands=True)
    seen = {}
    for name, mod in (("jax", j_run), ("port", t_run)):
        calls = seen[name] = []

        class Recorder:
            def __init__(self, **kw):
                calls.append(("init", kw["start_nerf_keyframes"],
                              kw["cfg_nerf"]["n_step"]))

            def run(self, color, depth, K, id_str, mask=None, occ_mask=None,
                    pose_in_model=None):
                calls.append((color, depth, K, id_str, mask, occ_mask,
                              pose_in_model))

            def on_finish(self):
                calls.append("finish")

        monkeypatch.setattr(mod, "BundleSdf", Recorder)
        monkeypatch.setattr(mod, "run_one_video_global_nerf",
                            lambda **kw: calls.append(("refine",
                                                       kw["refine_overrides"])))
        # the port's tracker would see cv2's features, as JAX's does
        extra = ({"matcher": OrbMatcher(device="cpu", detector=cv2_detector)}
                 if name == "port" else {})
        mod.run_one_video(video, str(tmp_path / name), stride=1, **extra,
                          online_overrides={"n_step": 7},
                          refine_overrides={"n_step": 3},
                          track_overrides={"bundle.window_size": 4})
    j, t = seen["jax"], seen["port"]
    assert len(t) == len(j) == 1 + 3 + 2
    assert t[0] == j[0] == ("init", 5, 7)
    assert t[-2:] == j[-2:] == ["finish", ("refine", {"n_step": 3})]
    for a, b in zip(t[1:4], j[1:4]):
        for x, y in zip(a, b):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    paths = ("debug_dir", "datadir", "save_dir")    # hold the out folder
    for f in ("config_bundletrack.yml", "config_nerf.yml"):
        pj, pt = str(tmp_path / "jax" / f), str(tmp_path / "port" / f)
        # PyYAML reads the port's file as the port does
        ct = j_run.load_config(pt, {})
        assert load_yaml(pt) == ct
        cj = j_run.load_config(pj, {})
        for c in (cj, ct):
            for k in paths:
                c.pop(k, None)
        assert ct == cj, f


def _refine_folder(root):
    """A refine output folder: a cleaned mesh and its config.yml."""
    d = os.path.join(root, "nerf_with_bundletrack_online")
    os.makedirs(d)
    xs = np.linspace(-1, 1, 20)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = np.minimum(np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5,
                     np.sqrt((X - 0.85) ** 2 + Y ** 2 + Z ** 2) - 0.1)
    from bundlesdf_tpu.mesh import marching_tetrahedra
    v, f = marching_tetrahedra(sdf, 0.0)
    Mesh(v / 19 * 2 - 1, f).export(os.path.join(d, "mesh_cleaned.obj"))
    dump_config({"sc_factor": 7.25, "translation": [0.01, -0.02, 0.5],
                 "n_step": 2000}, os.path.join(d, "config.yml"))


def test_postprocess_mesh_equals_jax(tmp_path):
    for name in ("jax", "port"):
        _refine_folder(str(tmp_path / name))
    j_run.postprocess_mesh(str(tmp_path / "jax"))
    t_run.main(["--mode", "postprocess_mesh", "--out_folder",
                str(tmp_path / "port")])
    for f in ("mesh_real_scale.obj", "mesh_biggest_component.obj",
              "mesh_biggest_component_smoothed.obj"):
        a = (tmp_path / "port" / "mesh" / f).read_text()
        assert a == (tmp_path / "jax" / "mesh" / f).read_text(), f
        assert len(a) > 1000


def test_draw_pose_equals_jax(tmp_path):
    seq = cube_orbit_sequence(n_frames=2, H=60, W=80)
    root = str(tmp_path / "jax")
    for sub in ("color", "ob_in_cam"):
        os.makedirs(f"{root}/{sub}")
    np.savetxt(f"{root}/cam_K.txt", seq["K"])
    for i, id_str in enumerate(seq["id_strs"]):
        cv2.imwrite(f"{root}/color/{id_str}.png", seq["colors"][i][..., ::-1])
        np.savetxt(f"{root}/ob_in_cam/{id_str}.txt",
                   np.linalg.inv(seq["cam_in_obs"][i]))
    _refine_folder(root)
    m = Mesh.load(f"{root}/nerf_with_bundletrack_online/mesh_cleaned.obj")
    m.vertices *= 0.05
    m.export(f"{root}/nerf_with_bundletrack_online/mesh_real_world.obj")
    shutil.copytree(root, str(tmp_path / "port"))
    j_run.draw_pose(root)
    t_run.draw_pose(str(tmp_path / "port"))
    for i, id_str in enumerate(seq["id_strs"]):
        a = read_png(str(tmp_path / "port" / "pose_vis" / f"{id_str}.png"))
        b = read_png(f"{root}/pose_vis/{id_str}.png")
        np.testing.assert_array_equal(a, b)
        assert (a != seq["colors"][i]).any()      # a box was drawn


def _same(a, b):
    """Equal values, floats bit for bit (-0.0 included)."""
    if isinstance(a, float):
        return (isinstance(b, float)
                and struct.pack("<d", a) == struct.pack("<d", b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


_scalars = (st.none() | st.booleans() | st.integers(-2 ** 70, 2 ** 70)
            | st.floats(allow_nan=False, allow_infinity=False)
            | st.text(max_size=12))
_values = st.recursive(_scalars, lambda c: st.lists(c, max_size=4)
                       | st.dictionaries(st.text(max_size=8), c, max_size=4),
                       max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(cfg=st.dictionaries(st.text(max_size=10), _values, max_size=6))
def test_config_files_read_back_in_pyyaml(tmp_path_factory, cfg):
    """What the port writes (`dump_config`, `dump_yaml`) PyYAML loads as
    the written values, bit for bit, and so does the port's reader."""
    p = str(tmp_path_factory.mktemp("cfg") / "config.yml")
    dump_config(cfg, p)
    with open(p) as f:
        back = yaml.safe_load(f)
    assert _same(back if cfg else {}, cfg)
    assert _same(load_yaml(p) if cfg else {}, cfg)


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf])
def test_config_files_refuse_non_finite_floats(tmp_path, bad):
    """A float without a form that both JSON and PyYAML read is refused,
    not written."""
    with pytest.raises(ValueError, match="cannot write the float"):
        dump_config({"lrate": 0.1, "bad": [1.0, bad]},
                    str(tmp_path / "c.yml"))


def test_real_configs_read_back_in_pyyaml(tmp_path):
    cfg_t, cfg_n = t_run.make_configs(str(tmp_path))
    cfg_n.update(t_run.REFINE_CONFIG, sc_factor=9.954873657226562,
                 translation=np.array([1e-5, -2.4e-4, 0.5]), lrate=1e-05)
    for cfg in (cfg_t, cfg_n):
        p = str(tmp_path / "c.yml")
        dump_config(cfg, p)
        want = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in cfg.items()}
        assert _same(j_run.load_config(p, {}), want)
        assert _same(load_yaml(p), want)
