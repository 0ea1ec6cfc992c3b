"""The plain LoFTR reference (`references/loftr_plain.py`) and the port's
LoFTR held against it, on the CPU:

- the reference against the golden fixture of the upstream network
  (`tests/fixtures/gen_loftr_golden.py`: upstream's state_dict at tiny
  dims, its stage taps, coarse confidence and fine matches), at rtol 1e-3
  / atol 1e-5, with equal match sets;
- the port loaded through `load_checkpoint` from a seeded checkpoint in
  upstream's layout (every BatchNorm moved off identity, so that the
  folding is exercised) against the reference at float32 and `match_thr`
  0: tiny dims on 64x64 and 96x96, full `LoftrConfig()` on 128x128; coarse
  confidence within 1e-5, the same matches, uv0 equal, uv1 within 1e-3
  px, conf within 1e-5;
- at the `custom_loftr` configuration's gains, on 400x400 pairs of the
  orbit: the port at bf16 within the `custom_loftr.track` cell's limits
  under its comparison, and the fp8, layer-skip and shifted-fine-window
  controls outside them;
- the benchmark's copy of the reference is this file byte for byte, and
  neither imports JAX or the port.
"""
import ast
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch.matcher import loftr as tl
from bundlesdf_tpu_torch.matcher.pairing import process_image_pairs
from perfbench import scene
from perfbench.drivers import track_loftr
from perfbench.tools import control_loftr
from references import loftr_plain as lp

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "loftr_golden_tiny.npz")
TINY = dict(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16, d_fine=8,
            nhead=2, n_coarse_layers=2, n_fine_layers=1, match_thr=0.0,
            max_matches=64)
CELL = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                   "custom_loftr.json")))
LIMITS = json.load(open(os.path.join(ROOT, "perfbench", "limits",
                                     "custom_loftr.track.json")))
NET_NUMBERS = ("loftr_missed_share", "loftr_uv1_gap_px")


def test_golden_fixture():
    d = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(np.asarray(d[k])) for k in d.files
          if k.startswith("sd/")}
    net = lp.load(sd, lp.Config(**TINY))
    img0 = torch.from_numpy(d["img0"])[None]
    img1 = torch.from_numpy(d["img1"])[None]
    tol = dict(rtol=1e-3, atol=1e-5)
    with torch.no_grad():
        feat_c, feat_f = net.backbone(torch.cat([img0, img1])[:, None])
        pe = net.pos_encoding(feat_c)
        f = pe.flatten(2).transpose(1, 2)
        fc0, fc1 = net.loftr_coarse(f[:1], f[1:])
        out = net(img0, img1)
    for name, got in (("feat_c", feat_c), ("feat_f", feat_f),
                      ("feat_c_pe", pe), ("fc0_tr", fc0), ("fc1_tr", fc1),
                      ("conf_matrix", out["conf_matrix"][0])):
        np.testing.assert_allclose(got.numpy(), d[name], **tol, err_msg=name)
    keep = out["conf"][0] > 0
    uv0, uv1 = out["uv0"][0][keep].numpy(), out["uv1"][0][keep].numpy()
    conf = out["conf"][0][keep].numpy()
    o, r = np.lexsort(uv0.T), np.lexsort(d["mkpts0"].T)
    np.testing.assert_array_equal(uv0[o], d["mkpts0"][r])
    np.testing.assert_allclose(uv1[o], d["mkpts1"][r], **tol)
    np.testing.assert_allclose(conf[o], d["mconf"][r], **tol)


def _images(size, seed):
    """A smooth random image in [0,1] and its copy shifted by 8 px."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((1, 1, size, size), generator=g)
    img = torch.nn.functional.avg_pool2d(img, 5, 1, 2)[0]
    return img, torch.roll(img, (8, 8), (1, 2))


def _kept(out, k=0):
    """{uv0: (uv1, conf)} of pair @k's kept slots."""
    keep = out["conf"][k] > 0
    return {tuple(u): (v, c) for u, v, c in zip(
        out["uv0"][k][keep].tolist(), out["uv1"][k][keep].float().numpy(),
        out["conf"][k][keep].tolist())}


@pytest.mark.parametrize("dims,size", [("tiny", 64), ("tiny", 96),
                                       ("full", 128)])
def test_port_from_checkpoint_equals_reference(tmp_path, dims, size):
    over = TINY if dims == "tiny" else dict(match_thr=0.0)
    sd = lp.seeded_state_dict(lp.Config(**over), seed=size)
    # every BatchNorm off identity, so that its folding into the conv
    # before it is exercised
    g = torch.Generator().manual_seed(1)
    for name, mod in lp.LoFTR(lp.Config(**over)).named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            for p in ("weight", "bias", "running_mean"):
                v = sd[f"{name}.{p}"]
                sd[f"{name}.{p}"] = v + 0.05 * torch.randn(v.shape,
                                                           generator=g)
            v = sd[f"{name}.running_var"]
            sd[f"{name}.running_var"] = v + 0.2 * torch.rand(v.shape,
                                                             generator=g)
    path = str(tmp_path / "seeded.ckpt")
    lp.write_checkpoint(path, sd)
    assert any(k.startswith("matcher.backbone.bn1.running_var")
               for k in torch.load(path)["state_dict"])
    port = tl.load_checkpoint(path, tl.LoftrConfig(**over))
    ref = lp.load(sd, lp.Config(**over))
    img0, img1 = _images(size, seed=size)
    with torch.no_grad():
        got = port(img0, img1, debug=True)
        want = ref(img0, img1)
    np.testing.assert_allclose(got["conf_matrix"].numpy(),
                               want["conf_matrix"].numpy(), rtol=0,
                               atol=1e-5)
    g, w = _kept(got), _kept(want)
    assert len(w) > 0 and set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k][0], w[k][0], rtol=0, atol=1e-3)
        assert abs(g[k][1] - w[k][1]) <= 1e-5


@pytest.fixture(scope="module")
def orbit_pairs():
    """Crops of four pairs of the cell's orbit at 400x400 (frames 1-10
    apart, ground-truth poses) and the cell's weights for seed 7."""
    p = dict(json.load(open(os.path.join(
        ROOT, "perfbench", "traffic", "track_loftr.json")))["scene"],
        erode_mask=CELL["track"]["erode_mask"])
    sc = scene.seeded_scene(7, p, 12, "cpu")
    fr = {i: SimpleNamespace(id=i, color=sc["colors"][i], H=p["H"],
                             W=p["W"], fg_mask=sc["masks"][i],
                             pose_in_model=sc["cam_in_obs"][i])
          for i in (11, 10, 6, 3, 1)}
    pairs = [(fr[11], fr[j]) for j in (10, 6, 3, 1)]
    A, B, _ = process_image_pairs(pairs, 400, "cpu")
    cell = SimpleNamespace(config=CELL, seed=7)
    return A, B, track_loftr.weights(cell)


def _net_numbers(got, ref):
    return track_loftr.compare_matches(
        got, ref, lp.Config().match_thr, LIMITS["decided_margin"])


@pytest.fixture(scope="module")
def reference_matches(orbit_pairs):
    A, B, sd = orbit_pairs
    return track_loftr.plain_outputs([(A, B, None)], sd, "cpu")


def test_bf16_port_within_the_cell_limits(tmp_path, orbit_pairs,
                                          reference_matches):
    A, B, sd = orbit_pairs
    path = str(tmp_path / "cell.ckpt")
    lp.write_checkpoint(path, sd)
    m = tl.LoftrMatcher(ckpt_path=path, cfg=tl.LoftrConfig(amp=True),
                        device="cpu")
    assert m.net.dtype == torch.bfloat16
    got = _net_numbers([m.predict(A, B)], reference_matches)
    print("bf16", got)
    assert got["matches"] >= 200 * got["pairs"], got
    for k in NET_NUMBERS:
        assert got[k] <= LIMITS[k], (k, got)


@pytest.mark.parametrize("kind", ["fp8", "skip_last_coarse",
                                  "shift_fine_window"])
def test_controls_exceed_the_cell_limits(orbit_pairs, reference_matches,
                                         kind):
    A, B, sd = orbit_pairs
    got = _net_numbers(track_loftr.plain_outputs(
        [(A, B, None)], sd, "cpu", control=control_loftr.CONTROLS[kind]),
        reference_matches)
    print(kind, got)
    assert any(got[k] > LIMITS[k] for k in NET_NUMBERS), got


def test_benchmark_copy_is_identical():
    a = open(os.path.join(ROOT, "references", "loftr_plain.py"), "rb").read()
    b = open(os.path.join(ROOT, "perfbench", "reference", "loftr_plain.py"),
             "rb").read()
    assert a == b


@pytest.mark.parametrize("rel", ["references/loftr_plain.py",
                                 "perfbench/reference/loftr_plain.py"])
def test_reference_imports_neither_jax_nor_the_port(rel):
    tree = ast.parse(open(os.path.join(ROOT, rel)).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, rel
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "contextlib", "math", "dataclasses",
                    "torch"}, mods
