"""The port's HO3D path against the JAX package's on the CPU:
`datasets.Ho3dReader` getter by getter on an HO3D-layout folder
(`tests/ho3d_layout.py`, 120x160, 4 frames, a palette XMem mask, an absent
hand mask, one objTrans of None), `rodrigues` against cv2.Rodrigues,
`run_ho3d`'s written configs and its `--parallel_videos` routing (the
port of `test_parallel_videos_flag.py`), `run_one_video` tracker-only
against the JAX script's, and `benchmark_ho3d`'s rows and `results.csv`
against the JAX script's and pandas'.

The JAX reader computes `depth[..., 2] + depth[..., 1] * 256` in the PNG's
sample type; under NumPy 2 that raises OverflowError for HO3D's 8-bit
depth PNGs (a fault of the reference). The folders held against the JAX
package therefore store the same depth values as 16-bit samples; the
port reads both and gives the same depth."""
import os
import pickle

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from PIL import Image

import benchmark_ho3d as j_bench
import ho3d_layout
import run_ho3d as j_run
from orb_cv2 import cv2_detector
from synthetic import cube_orbit_sequence

from bundlesdf_tpu.datasets import Ho3dReader as JReader
from bundlesdf_tpu_torch import benchmark_ho3d as t_bench
from bundlesdf_tpu_torch import run_ho3d as t_run
from bundlesdf_tpu_torch.datasets import Ho3dReader
from bundlesdf_tpu_torch.datasets.readers import rodrigues
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher

torch.set_num_threads(2)
PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0]


def _layout(root, depth_dtype=np.uint16, n=4, **kw):
    seq = cube_orbit_sequence(n_frames=n, H=120, W=160, full_angle=0.35,
                              noise=0.002)
    video = ho3d_layout.write_ho3d_video(str(root), seq, n_frames=n,
                                         depth_dtype=depth_dtype, **kw)
    return seq, video


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("ho3d")
    seq, video = _layout(root, trans_none=(3,), hand_absent=(1,))
    # frame 2's XMem mask as a palette image, as XMem writes them
    p = Image.fromarray((seq["masks"][2] > 0).astype(np.uint8), "P")
    p.putpalette(PALETTE)
    p.save(str(root / "masks_XMem" / "SYN1" / "00002.png"))
    return seq, video


def test_reader_equals_jax(folder):
    seq, video = folder
    t, j = Ho3dReader(video), JReader(video)
    assert (len(t), t.id_strs, t.get_video_name(), t.ho3d_root) == \
        (len(j), j.id_strs, j.get_video_name(), j.ho3d_root)
    np.testing.assert_array_equal(t.K, j.K)
    for i in range(len(j)):
        for get in ("get_color", "get_depth", "get_mask", "get_occ_mask",
                    "get_xyz_map"):
            a, b = getattr(t, get)(i), getattr(j, get)(i)
            if b is None:
                assert a is None, (get, i)
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (get, i)
            np.testing.assert_array_equal(a, b, err_msg=f"{get} {i}")
        a, b = t.get_gt_pose(i), j.get_gt_pose(i)
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # the traps: cv2's BGR channels of the palette mask, the absent hand
    # mask, the objTrans of None
    assert t.get_mask(2).shape == (120, 160, 3)
    np.testing.assert_array_equal(
        t.get_mask(2)[..., ::-1],
        np.asarray(PALETTE, np.uint8).reshape(-1, 3)[
            (seq["masks"][2] > 0).astype(int)])
    assert t.get_occ_mask(1) is None and t.get_gt_pose(3) is None
    # what was written comes back, within the depth pack's quantization
    for i in range(3):
        np.testing.assert_allclose(t.get_gt_pose(i),
                                   np.linalg.inv(seq["cam_in_obs"][i]),
                                   atol=1e-12)
        assert np.abs(t.get_depth(i) - seq["depths"][i]).max() <= \
            ho3d_layout.DEPTH_SCALE / 2 + 1e-6


def test_eight_bit_depth(tmp_path, folder):
    """HO3D's own 8-bit depth PNGs: the JAX reader overflows under NumPy 2;
    the port gives the depth it gives for the 16-bit file."""
    _, video16 = folder
    _, video8 = _layout(tmp_path, depth_dtype=np.uint8)
    t8, t16, j8 = Ho3dReader(video8), Ho3dReader(video16), JReader(video8)
    assert cv2.imread(t8.color_files[0].replace("rgb", "depth")
                      .replace(".jpg", ".png"), -1).dtype == np.uint8
    with pytest.raises(OverflowError):
        j8.get_depth(0)
    for i in range(len(t8)):
        d8 = t8.get_depth(i)
        assert d8.dtype == np.float32
        np.testing.assert_array_equal(d8, t16.get_depth(i))


def test_rodrigues_equals_cv2():
    rng = np.random.default_rng(0)
    vecs = [rng.normal(size=3) * s for s in (1e-9, 1e-3, 0.5, 2.0, 3.1)
            for _ in range(20)] + [np.zeros(3), np.array([np.pi, 0, 0])]
    for r in vecs:
        np.testing.assert_allclose(rodrigues(r), cv2.Rodrigues(r)[0],
                                   rtol=0, atol=1e-12)


class _Stub:
    def __init__(self, **kw):
        self.kw = kw


def test_make_tracker_configs_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(j_run, "BundleSdf", _Stub)
    monkeypatch.setattr(t_run, "BundleSdf", _Stub)
    j = j_run._make_tracker("VID", str(tmp_path / "out"), use_gui=True)
    ja = {f: (tmp_path / "out" / f).read_text()
          for f in ("config_bundletrack.yml", "config_nerf.yml")}
    t = t_run._make_tracker("VID", str(tmp_path / "out"), use_gui=True,
                            device="cpu")
    assert t.kw.pop("device") == "cpu"
    assert t.kw == j.kw
    for f, text in ja.items():
        assert yaml.safe_load((tmp_path / "out" / f).read_text()) == \
            yaml.safe_load(text), f


class _FakeReader:
    def __init__(self, video_dir):
        self.video_dir = video_dir
        self.color_files = ["a", "b"]
        self.K = np.eye(3)
        self.id_strs = ["0000", "0001"]

    def get_video_name(self):
        return self.video_dir.rstrip("/").split("/")[-1]


def test_parallel_videos_routes_to_sweep(monkeypatch, tmp_path):
    monkeypatch.setattr(t_run, "Ho3dReader", _FakeReader)
    sweeps = []

    def fake_sweep(jobs, make_tracker, n_devices=None, devices=None):
        sweeps.append({"n_jobs": len(jobs), "n_devices": n_devices,
                       "devices": devices})
        for _, of in jobs:
            assert make_tracker(of, torch.device("cpu")) is not None
        return [object()] * len(jobs)

    made = []
    monkeypatch.setattr(t_run, "_make_tracker",
                        lambda vd, of, use_gui=False, device="cuda":
                        made.append((vd, of, device)) or "tracker")
    import bundlesdf_tpu_torch.parallel.videos as pv
    monkeypatch.setattr(pv, "run_videos_parallel", fake_sweep)

    dirs = [str(tmp_path / f"vid{i}") for i in range(3)]
    t_run.run_videos(dirs, str(tmp_path / "out"), parallel_videos=2,
                     device="cpu")
    # 3 videos, chunked 2 + 1, each job on a CPU device of its own
    assert [s["n_jobs"] for s in sweeps] == [2, 1]
    assert all(s["n_devices"] == 2 for s in sweeps)
    assert all(s["devices"] == [torch.device("cpu")] * 2 for s in sweeps)
    assert len(made) == 3
    assert {vd.split("/")[-1] for vd, _, _ in made} == {"vid0", "vid1",
                                                       "vid2"}


@pytest.mark.parametrize("device,devices", [
    ("cuda", None),
    ("cuda:1", [torch.device("cuda", 1)] * 2),
    ("cpu", [torch.device("cpu")] * 2)])
def test_parallel_videos_device_flag(monkeypatch, tmp_path, device, devices):
    """--device "cuda" spreads the videos over the visible cards; a named
    device takes every video of the sweep."""
    monkeypatch.setattr(t_run, "Ho3dReader", _FakeReader)
    got = []
    import bundlesdf_tpu_torch.parallel.videos as pv
    monkeypatch.setattr(pv, "run_videos_parallel",
                        lambda jobs, make_tracker, n_devices=None,
                        devices=None: got.append(devices))
    t_run.run_videos([str(tmp_path / "a"), str(tmp_path / "b")],
                     str(tmp_path / "out"), parallel_videos=2, device=device)
    assert got == [devices]


def test_default_out_folders_are_new(monkeypatch, tmp_path):
    """Without --out_dir / --log_dir each run writes to a new folder under
    the temporary directory, so it never skips or scores another run's
    output; global_refine has nothing to refine without --out_dir."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    outs = []
    monkeypatch.setattr(t_run, "run_videos",
                        lambda dirs, out_dir, **kw: outs.append(out_dir))
    for _ in range(2):
        t_run.main(["--video_dirs", "V", "--device", "cpu"])
    assert outs[0] != outs[1]
    for o in outs:
        assert os.path.dirname(o) == str(tmp_path) and not os.listdir(o)
    with pytest.raises(SystemExit):
        t_run.main(["--video_dirs", "V", "--mode", "global_refine",
                    "--device", "cpu"])

    monkeypatch.setattr(t_bench, "benchmark_one_video",
                        lambda vd, od: {f"ours/{vd}/ADD(cm)": 0.5})
    before = set(os.listdir(tmp_path))
    for _ in range(2):
        t_bench.main(["--video_dirs", "V", "--out_dir", "RUNS"])
    logs = set(os.listdir(tmp_path)) - before
    assert len(logs) == 2
    for d in logs:
        assert os.listdir(tmp_path / d) == ["results.csv"]


def test_sequential_path_unchanged(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(t_run, "run_one_video",
                        lambda vd, od, use_gui=False, device="cuda":
                        calls.append((vd, device)))
    t_run.run_videos(["a", "b"], str(tmp_path), parallel_videos=0,
                     device="cpu")
    assert calls == [("a", "cpu"), ("b", "cpu")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`run_one_video` of both packages on a 5-frame folder (grey XMem
    masks, as the JAX tracker needs), the NOF start pushed past the last
    frame, the port fed cv2's features."""
    _, video = _layout(tmp_path_factory.mktemp("ho3d_run"), n=5,
                       trans_none=(3,))
    out = {}
    for name, mod in (("jax", j_run), ("port", t_run)):
        real = mod.BundleSdf

        def tracker_only(real=real, name=name, **kw):
            kw["start_nerf_keyframes"] = 10 ** 9
            if name == "port":
                kw["matcher"] = OrbMatcher(device="cpu",
                                           detector=cv2_detector)
            return real(**kw)

        mod.BundleSdf = tracker_only
        try:
            out_dir = str(tmp_path_factory.mktemp(name))
            extra = {"device": "cpu"} if name == "port" else {}
            t = mod.run_one_video(video, out_dir, **extra)
            out[name] = (out_dir, t)
        finally:
            mod.BundleSdf = real
    return video, out


def test_run_one_video_equals_jax(runs):
    """Poses per frame within 2 mm and 1 deg of JAX's (RANSAC draws
    differ, as in test_torch_tracker.py), the same files written."""
    video, out = runs
    (dj, _), (dt, tracker) = out["jax"], out["port"]
    assert tracker is not None and tracker.device.type == "cpu"
    ids = Ho3dReader(video).id_strs
    for i in ids:
        Tj = np.loadtxt(f"{dj}/SYN1/ob_in_cam/{i}.txt")
        Tt = np.loadtxt(f"{dt}/SYN1/ob_in_cam/{i}.txt")
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.002, i
        cos = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0, i
    assert sorted(os.listdir(f"{dt}/SYN1")) == sorted(os.listdir(f"{dj}/SYN1"))
    # done before: a second run skips the video
    assert t_run.run_one_video(video, dt, device="cpu") is None


def test_benchmark_rows_and_csv_equal_jax(runs, tmp_path, monkeypatch):
    video, out = runs
    run_dir = out["jax"][0]
    rows_j = j_bench.benchmark_one_video(video, run_dir)
    rows_t = t_bench.benchmark_one_video(video, run_dir)
    assert list(rows_t) == list(rows_j)
    assert rows_t["ours/SYN1/ADD(cm)"] < 0.5        # the run tracked
    for k in rows_j:
        assert rows_t[k] == pytest.approx(rows_j[k], rel=1e-12, abs=0), k
    # the CSV, a NaN row included, byte for byte what pandas writes
    rows = dict(rows_t, **{"ours/SYN1/missing": float("nan")})
    t_bench.write_results_csv(rows, str(tmp_path / "port.csv"))
    pd.DataFrame([{"key": k, "value": v} for k, v in rows.items()]).to_csv(
        str(tmp_path / "pandas.csv"), index=False)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "pandas.csv").read_bytes()
    # the command line end to end
    got = t_bench.main(["--video_dirs", video, "--out_dir", run_dir,
                        "--log_dir", str(tmp_path / "log")])
    assert got == rows_t
    assert (tmp_path / "log" / "results.csv").exists()
    assert not (tmp_path / "log" / "results.xlsx").exists()


def test_meta_pickle_layout(folder):
    """The meta pickles hold what HO3D's do: camMat, objRot (3, 1) and
    objTrans (3,) in the GL convention."""
    _, video = folder
    with open(os.path.join(video, "meta", "0000.pkl"), "rb") as f:
        meta = pickle.load(f)
    assert meta["camMat"].shape == (3, 3)
    assert meta["objRot"].shape == (3, 1) and meta["objTrans"].shape == (3,)
    assert meta["objTrans"][2] < 0          # in front of a GL camera
