"""The port's protocol driver (`bundlesdf_tpu_torch/benchmark_synthetic.py`)
against the JAX driver (the top-level `benchmark_synthetic.py`):

- `write_sequence` of each protocol (60x80, 4 frames), read back by the
  JAX package's `YcbineoatReader`, is pixel-equal to what the JAX
  `write_sequence` wrote (it writes with imageio and cv2, the port with
  `utils/png.py`);
- the ground-truth mesh and surface samples are bit-equal;
- `--track_override` values parse to what `yaml.safe_load` gives;
- the driver, run `--no_nerf --skip_refine` on a tiny easy and a tiny
  occluder sequence, writes a `metrics.json` equal within 1e-6 to the JAX
  package's `benchmark_video`, `collect_frame_statuses` and post-recovery
  ADD applied to the same run folder (the JAX driver's scoring, lines
  216-253 of its file, at stride 1); the tracker is fed cv2's features;
- `--orb_features` replays each frame's stored features, and a file with
  fewer frames than the sequence is refused.
"""
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from orb_cv2 import cv2_detector

import benchmark_synthetic as jax_driver
from bundlesdf_tpu.datasets import YcbineoatReader as JaxReader
from bundlesdf_tpu.eval.benchmark import benchmark_video as jax_benchmark_video
from bundlesdf_tpu.eval.metrics import add_err as jax_add_err
from bundlesdf_tpu.mesh import Mesh as JaxMesh
from bundlesdf_tpu_torch import benchmark_synthetic as driver
from bundlesdf_tpu_torch import bundlesdf as tbsdf
from bundlesdf_tpu_torch.matcher.classical import OrbMatcher

torch.set_num_threads(2)

METRIC_TOL = 1e-6


@pytest.mark.parametrize("protocol", ["easy", "occluder", "translation"])
def test_write_sequence_reads_back_as_jax(tmp_path, protocol):
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    seq = driver.write_sequence(ours, 4, 60, 80, 0.002, protocol=protocol)
    jax_driver.write_sequence(ref, 4, 60, 80, 0.002, protocol=protocol)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    a, b = JaxReader(ours), JaxReader(ref)
    assert a.id_strs == b.id_strs == seq["id_strs"]
    np.testing.assert_array_equal(a.K, b.K)
    for i in range(4):
        np.testing.assert_array_equal(a.get_color(i), b.get_color(i))
        np.testing.assert_array_equal(a.get_depth(i), b.get_depth(i))
        np.testing.assert_array_equal(a.get_mask(i), b.get_mask(i))
        if protocol == "occluder":
            np.testing.assert_array_equal(a.get_occ_mask(i),
                                          b.get_occ_mask(i))
        for path in (ours, ref):
            np.testing.assert_array_equal(
                np.loadtxt(f"{path}/annotated_poses/{seq['id_strs'][i]}.txt"),
                np.linalg.inv(seq["cam_in_obs"][i]))
    assert ("masks_hand" in os.listdir(ours)) == (protocol == "occluder")


def test_ground_truth_is_bit_equal():
    m, j = driver.gt_mesh(), jax_driver.gt_mesh()
    np.testing.assert_array_equal(m.vertices, j.vertices)
    np.testing.assert_array_equal(m.faces, j.faces)
    for n, seed in ((20000, 0), (60000, 1)):
        np.testing.assert_array_equal(driver.gt_surface_points(n, seed=seed),
                                      jax_driver.gt_surface_points(n,
                                                                   seed=seed))


OVERRIDES = [
    "bundle.reassoc_iters=7", "a.b=-3", "x=+4", "x=0", "x=0.25",
    "x=-2.5e+3", "x=1.0e-5", "x=.5", "x=1.", "x=true", "x=False", "x=yes",
    "x=off", "x=ON", "x=null", "x=~", "x=", "x=window", "x=hybrid mode",
    "x=a,b", "x='quoted'", "x='it''s'", 'x="two words"',
    "x=[1, 2.5, true, name]", "x=[]", "x=[1, 2,]", "x=a=b",
]
# forms PyYAML reads in another notation (octal, hex, `_`, sexagesimal,
# `.inf`, `1e-3` as a string, timestamps) or as nested YAML: refused
REFUSED = [
    "x=0x1F", "x=017", "x=1_000", "x=1:30", "x=1e-3", "x=-.5", "x=.inf",
    "x=2001-12-14", "x=[[1, 2], [3]]", "x=[a, 'b,c']", "x=[1,,2]",
    "x={a: 1}", "x=a: b", "x=&anchor", "x='open",
]


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def test_track_override_parse_equals_yaml():
    rng = np.random.default_rng(0)
    items = list(OVERRIDES)
    for _ in range(200):
        kind = rng.integers(5)
        if kind == 0:
            v = str(int(rng.integers(-10 ** 6, 10 ** 6)))
        elif kind == 1:
            v = repr(float(rng.normal() * 10.0 ** rng.integers(-8, 8)))
        elif kind == 2:
            v = str(rng.choice(["true", "True", "false", "FALSE", "on",
                                "No"]))
        elif kind == 3:
            v = "".join(rng.choice(list("abcxyz_")) for _ in range(6))
        else:
            v = "[" + ", ".join(str(int(x)) for x in
                                rng.integers(0, 9, rng.integers(0, 4))) + "]"
        items.append(f"k.v={v}")
    got = driver.parse_track_overrides(items)
    for item in items:
        key, _, val = item.partition("=")
        want = yaml.safe_load(val)
        got_one = driver.parse_track_overrides([item])[key]
        assert _same(got_one, want), (item, got_one, want)
    assert set(got) == {i.partition("=")[0] for i in items}


@pytest.mark.parametrize("item", REFUSED)
def test_track_override_refuses_other_yaml(item):
    with pytest.raises(ValueError):
        driver.parse_track_overrides([item])


def jax_scoring(out_folder, seq, protocol):
    """The JAX driver's scoring of a run folder (its file, :216-253),
    stride 1, with the JAX package's functions."""
    gt_poses = np.linalg.inv(seq["cam_in_obs"])
    model_pts = jax_driver.gt_surface_points(20000)
    visible_pts = jax_driver.gt_surface_points(60000, seed=1)
    mesh_path = os.path.join(out_folder, "nerf_with_bundletrack_online",
                             "mesh_real_world.obj")
    pred_mesh = JaxMesh.load(mesh_path) if os.path.exists(mesh_path) \
        else None
    metrics = jax_benchmark_video(out_folder, gt_poses, model_pts,
                                  gt_visible_pts=visible_pts,
                                  pred_mesh=pred_mesh)
    statuses = jax_driver.collect_frame_statuses(out_folder, seq["id_strs"])
    n_fail = sum(s == "FAIL" for s in statuses)
    metrics["fail_frames"] = n_fail
    if protocol == "occluder" or n_fail:
        last_fail = max((i for i, s in enumerate(statuses) if s == "FAIL"),
                        default=-1)
        post = statuses[last_fail + 1:]
        metrics["recovered"] = bool(last_fail >= 0 and post
                                    and all(s != "FAIL" for s in post))
        pose_files = sorted(glob.glob(f"{out_folder}/ob_in_cam/*.txt"))
        pred = np.array([np.loadtxt(f) for f in pose_files])
        pred = pred @ np.linalg.inv(pred[0]) @ gt_poses[0]
        errs = [jax_add_err(p, g, model_pts) for p, g in
                zip(pred[last_fail + 1:], gt_poses[last_fail + 1:])]
        metrics["ADD_post_recovery(cm)"] = float(np.mean(errs) * 100)
    return metrics, statuses


@pytest.mark.parametrize("protocol", ["easy", "occluder"])
def test_driver_metrics_equal_jax_scoring(tmp_path, protocol, monkeypatch):
    # the tracker sees cv2's features, as the JAX driver's does
    monkeypatch.setattr(tbsdf, "OrbMatcher", lambda device: OrbMatcher(
        device=device, detector=cv2_detector))
    out = str(tmp_path / protocol)
    ours = driver.main(["--out", out, "--n_frames", "8", "--H", "60",
                        "--W", "80", "--protocol", protocol, "--no_nerf",
                        "--skip_refine", "--device", "cpu"])
    with open(os.path.join(out, "metrics.json")) as f:
        written = json.load(f)
    assert list(written) == list(ours)
    seq = driver.write_sequence(str(tmp_path / "again"), 8, 60, 80, 0.002,
                                protocol=protocol)
    want, statuses = jax_scoring(os.path.join(out, "run"), seq, protocol)
    assert "MISSING" not in statuses
    assert written["n_frames"] == 8.0 and written["protocol"] == protocol
    assert written["resolution"] == "80x60"
    assert written["depth_noise_m"] == 0.002
    for k, v in want.items():
        if isinstance(v, bool):
            assert written[k] == float(v), k
        elif math.isinf(v):
            assert written[k] == v, k
        elif math.isnan(v):      # no frame after the last FAIL
            assert math.isnan(written[k]), k
        else:
            assert written[k] == pytest.approx(float(v), abs=METRIC_TOL), k
    # the JAX driver's keys, in its order
    assert list(written) == [k for k in want if k not in (
        "fail_frames", "recovered", "ADD_post_recovery(cm)")] + [
        "wall_s", "n_frames", "resolution", "depth_noise_m", "protocol"] + [
        k for k in ("fail_frames", "recovered", "ADD_post_recovery(cm)")
        if k in want]


@pytest.mark.parametrize("stale", ["ob_in_cam", "textured_mesh.obj"])
def test_driver_refuses_an_earlier_runs_outputs(tmp_path, stale):
    """An --out whose run/ holds an earlier run's poses or refined mesh is
    refused before anything is written (score() would read them as this
    run's); --skip_run without --out has nothing to score."""
    run = tmp_path / "run"
    run.mkdir()
    (run / stale).mkdir()
    with pytest.raises(SystemExit):
        driver.main(["--out", str(tmp_path), "--n_frames", "2", "--H", "60",
                     "--W", "80", "--no_nerf", "--skip_refine",
                     "--device", "cpu"])
    assert not (tmp_path / "video").exists()
    with pytest.raises(SystemExit):
        driver.main(["--skip_run", "--device", "cpu"])


def _features_npz(path, counts):
    """An .npz in `tests/fixtures/gen_tracker_orb.py`'s layout: @counts
    features a frame, random uv and descriptors."""
    rng = np.random.default_rng(0)
    n = int(np.sum(counts))
    uv = rng.uniform(0, 50, (n, 2)).astype(np.float32)
    des = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    np.savez(path, counts=np.asarray(counts, np.int32), uv=uv, des=des)
    return uv, des


@pytest.mark.parametrize("counts", [[3, 2], [3]], ids=["two", "too_few"])
def test_replayed_features(tmp_path, counts):
    """`replay_matcher` gives each frame its own slice of the stored
    features, and refuses a file that holds fewer frames than the
    sequence."""
    path = str(tmp_path / "feats.npz")
    uv, des = _features_npz(path, counts)
    if len(counts) < 2:
        with pytest.raises(ValueError, match="holds 1 frames"):
            driver.replay_matcher(path, ["0000", "0001"], "cpu")
        return
    m = driver.replay_matcher(path, ["0000", "0001"], "cpu")
    got = m.detector(type("F", (), {"id_str": "0001"})())
    np.testing.assert_array_equal(got[0], uv[3:])
    np.testing.assert_array_equal(got[1], des[3:])


def test_driver_refuses_too_few_replayed_frames(tmp_path):
    """--orb_features with fewer frames than --n_frames stops the driver
    before it tracks."""
    path = str(tmp_path / "feats.npz")
    _features_npz(path, [3])
    with pytest.raises(ValueError, match="holds 1 frames, the sequence 2"):
        driver.main(["--out", str(tmp_path / "out"), "--n_frames", "2",
                     "--H", "60", "--W", "80", "--no_nerf", "--skip_refine",
                     "--device", "cpu", "--orb_features", path])
    assert not (tmp_path / "out" / "run").exists()
