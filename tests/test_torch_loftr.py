"""The port's LoFTR (`bundlesdf_tpu_torch/matcher/loftr.py`) held against
the reference torch network and against the JAX package, on the CPU:

- the golden fixture (`tests/fixtures/gen_loftr_golden.py`: the
  reference LoFTR's own state_dict at tiny dims, its inputs, stage taps,
  coarse confidence matrix and fine matches) through
  `load_reference_state_dict`, at the JAX test's rtol 1e-3 / atol 1e-5,
  with equal match sets;
- both weight bridges give identical modules;
- the forward against JAX `loftr_forward` with the same weights (the
  fixture's through both loaders, and `init_loftr_params(PRNGKey(0))`
  through `params_from_jax`) at tiny dims on 64x64 and 96x96 and at full
  `LoftrConfig()` on 128x128, `match_thr` 0: conf_matrix within rtol
  1e-3 / atol 1e-5, uv0 equal, uv1 within 1e-3 px, conf within 1e-5;
- bf16 (`amp`) against JAX's bf16 forward and against its own f32 one,
  with the tolerances of `tests/test_loftr.py::test_amp_forward_close_to_f32`;
- the `predict` contract: batched = single calls, shapes grouped, empty
  in empty out, (N,5) float32, and equal to JAX `LoftrMatcher.predict`;
- the benchmark's FLOP count of a pair (`perfbench/loftr_flops.py`)
  against forward hooks at tiny and at full widths.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlesdf_tpu.matcher import loftr as jl
from bundlesdf_tpu_torch.matcher import loftr as tl

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "loftr_golden_tiny.npz")
TINY = dict(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16, d_fine=8,
            nhead=2, n_coarse_layers=2, n_fine_layers=1, match_thr=0.0,
            max_matches=64)


@pytest.fixture(scope="module")
def golden():
    d = np.load(FIXTURE)
    sd = {k[3:]: d[k] for k in d.files if k.startswith("sd/")}
    return d, sd


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def blobs(H, W, seed, n=None):
    """Smooth random blobs in [0,1] (random-init nets collapse white noise
    to near-constant features, which makes the dual softmax degenerate)."""
    r = np.random.default_rng(seed)
    img = np.zeros((H, W), np.float32)
    y, x = np.mgrid[0:H, 0:W]
    for _ in range(n or max(8, H * W // 4000)):
        cx, cy = r.uniform(0, W), r.uniform(0, H)
        s = r.uniform(3, max(4, H / 10))
        img += r.uniform(0.2, 1.0) * np.exp(
            -((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))
    img -= img.min()
    return (img / img.max()).astype(np.float32)


def test_golden_reference(golden):
    d, sd = golden
    cfg = tl.LoftrConfig(**TINY)
    net = tl.load_reference_state_dict(sd, cfg)
    img0 = torch.from_numpy(d["img0"])[None]
    img1 = torch.from_numpy(d["img1"])[None]
    tol = dict(rtol=1e-3, atol=1e-5)
    with torch.no_grad():
        feat_c, feat_f = net.backbone(torch.cat([img0, img1])[:, None])
        pe = net.pos_encoding(feat_c)
        f = pe.flatten(2).transpose(1, 2)
        fc0, fc1 = net.loftr_coarse(f[:1], f[1:])
        out = net(img0, img1, debug=True)
    reached = {}
    for name, got in (("feat_c", feat_c), ("feat_f", feat_f),
                      ("feat_c_pe", pe), ("fc0_tr", fc0), ("fc1_tr", fc1),
                      ("conf_matrix", out["conf_matrix"][0])):
        np.testing.assert_allclose(got.numpy(), d[name], **tol, err_msg=name)
        reached[name] = float(np.abs(got.numpy() - d[name]).max())
    keep = out["conf"][0] > 0
    uv0 = out["uv0"][0][keep].numpy()
    uv1 = out["uv1"][0][keep].numpy()
    conf = out["conf"][0][keep].numpy()
    assert ({tuple(u) for u in uv0.astype(int)}
            == {tuple(u) for u in d["mkpts0"].astype(int)})
    o, r = np.lexsort(uv0.T), np.lexsort(d["mkpts0"].T)
    np.testing.assert_array_equal(uv0[o], d["mkpts0"][r])
    np.testing.assert_allclose(uv1[o], d["mkpts1"][r], **tol)
    np.testing.assert_allclose(conf[o], d["mconf"][r], **tol)
    reached["mkpts1"] = float(np.abs(uv1[o] - d["mkpts1"][r]).max())
    reached["mconf"] = float(np.abs(conf[o] - d["mconf"][r]).max())
    print("max abs difference from the reference:", reached)


def test_bridges_give_identical_modules(golden):
    _, sd = golden
    cfg = tl.LoftrConfig(**TINY)
    a = tl.load_reference_state_dict(sd, cfg).state_dict()
    params = jl.convert_torch_state_dict(sd, jl.LoftrConfig(**TINY))
    b = tl.params_from_jax(_np_tree(params), cfg).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # each BatchNorm's five tensors become its conv's bias
    bn_keys = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(a) == len(sd) - 4 * bn_keys


def _compare_with_jax(net, params, cfg_t, cfg_j, img0, img1):
    with torch.no_grad():
        got = net(torch.from_numpy(img0)[None], torch.from_numpy(img1)[None],
                  debug=True)
    want = jl.loftr_forward(params, jnp.asarray(img0), jnp.asarray(img1),
                            cfg_j, debug=True)
    got = {k: v[0].float().numpy() for k, v in got.items()}
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    return got, want


CASES = [("fixture_sd", "tiny", 64), ("fixture_sd", "tiny", 96),
         ("jax_init", "tiny", 64), ("jax_init", "tiny", 96),
         ("jax_init", "full", 128)]


@pytest.mark.parametrize("weights,dims,size", CASES)
def test_forward_equals_jax(golden, weights, dims, size):
    _, sd = golden
    over = TINY if dims == "tiny" else dict(match_thr=0.0)
    cfg_t, cfg_j = tl.LoftrConfig(**over), jl.LoftrConfig(**over)
    if weights == "fixture_sd":
        params = jl.convert_torch_state_dict(sd, cfg_j)
        net = tl.load_reference_state_dict(sd, cfg_t)
    else:
        params = jl.init_loftr_params(jax.random.PRNGKey(0), cfg_j)
        net = tl.params_from_jax(_np_tree(params), cfg_t)
    img0 = blobs(size, size, seed=size)
    img1 = np.roll(img0, (8, 8), axis=(0, 1))
    got, want = _compare_with_jax(net, params, cfg_t, cfg_j, img0, img1)
    np.testing.assert_allclose(got["conf_matrix"], want["conf_matrix"],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(got["uv0"], want["uv0"])
    np.testing.assert_array_equal(got["conf"] > 0, want["conf"] > 0)
    np.testing.assert_allclose(got["uv1"], want["uv1"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["conf"], want["conf"], rtol=0, atol=1e-5)
    assert (got["conf"] > 0).sum() > 0
    print(f"{weights} {dims} {size}x{size}: {(got['conf'] > 0).sum()} "
          f"matches; max |d conf_matrix| "
          f"{np.abs(got['conf_matrix'] - want['conf_matrix']).max():.3g}, "
          f"|d uv1| {np.abs(got['uv1'] - want['uv1']).max():.3g} px, "
          f"|d conf| {np.abs(got['conf'] - want['conf']).max():.3g}")


def _amp_close(a, b, what):
    """tests/test_loftr.py:234-281's tolerances between two forwards."""
    ca, cb = a["conf_matrix"].ravel(), b["conf_matrix"].ravel()
    assert np.abs(ca - cb).max() < 0.05, what
    assert np.corrcoef(ca, cb)[0, 1] > 0.99, what
    ma = {tuple(u): (v, c) for u, v, c in zip(a["uv0"], a["uv1"], a["conf"])
          if c > 0}
    mb = {tuple(u): (v, c) for u, v, c in zip(b["uv0"], b["uv1"], b["conf"])
          if c > 0}
    shared = set(ma) & set(mb)
    assert len(ma) > 0, what
    assert len(shared) >= max(1, int(0.8 * len(ma))), what
    for k in shared:
        assert np.abs(ma[k][0] - mb[k][0]).max() < 1.0, (what, k)
        assert abs(ma[k][1] - mb[k][1]) < 0.05, (what, k)
    return len(shared), len(ma)


def test_amp_against_jax_and_f32():
    over = dict(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16,
                d_fine=8, nhead=2, n_coarse_layers=1, max_matches=16,
                match_thr=1e-4)
    cfg_j = jl.LoftrConfig(**over)
    params = jl.init_loftr_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(3)
    img0 = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    img1 = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    amp_j = dataclasses.replace(cfg_j, amp=True)
    out = {}
    for amp in (False, True):
        cfg_t = tl.LoftrConfig(**over, amp=amp)
        net = tl.params_from_jax(_np_tree(params), cfg_t)
        assert net.dtype == (torch.bfloat16 if amp else torch.float32)
        out[amp], jax_out = _compare_with_jax(
            net, params, cfg_t, amp_j if amp else cfg_j, img0, img1)
        if amp:
            jax16 = jax_out
    assert out[True]["uv0"].dtype == np.float32
    print("amp vs JAX amp: shared / matches",
          _amp_close(out[True], jax16, "port bf16 vs JAX bf16"))
    print("amp vs f32: shared / matches",
          _amp_close(out[False], out[True], "port f32 vs port bf16"))


def _matchers(cfg_over):
    cfg_j = jl.LoftrConfig(**cfg_over)
    params = jl.init_loftr_params(jax.random.PRNGKey(0), cfg_j)
    mj = jl.LoftrMatcher(params=params, cfg=cfg_j)
    mt = tl.LoftrMatcher(params=_np_tree(params),
                         cfg=tl.LoftrConfig(**cfg_over), device="cpu",
                         max_batch=2)
    return mj, mt


def _rgb(seed, H, W):
    g = (blobs(H, W, seed) * 255).astype(np.uint8)
    return np.stack([g, np.roll(g, 3, 0), 255 - g], -1)


def test_predict_contract_and_jax():
    over = dict(initial_dim=8, block_dims=(8, 12, 16), d_coarse=16,
                d_fine=8, nhead=2, n_coarse_layers=1, n_fine_layers=1,
                match_thr=0.0, max_matches=32)
    mj, mt = _matchers(over)
    assert mt.predict([], []) == []
    # mixed shapes (one 72x100 pair, cropped to 72x96), RGB and grey
    imgsA = [_rgb(i, 64, 64) for i in range(3)] + [_rgb(7, 72, 100)]
    imgsB = [np.roll(a, (8, 8), (0, 1)) for a in imgsA[:2]]
    imgsB += [_rgb(11, 64, 64)[..., 0], np.roll(imgsA[3], 8, 1)]
    batched = mt.predict(imgsA, imgsB)
    singles = [mt.predict([a], [b])[0] for a, b in zip(imgsA, imgsB)]
    want = mj.predict(imgsA, imgsB)
    assert len(batched) == len(want) == 4
    for got, one, ref in zip(batched, singles, want):
        assert got.dtype == np.float32 and got.ndim == 2
        assert got.shape[1] == 5
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-5)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[:, :2], ref[:, :2])
        np.testing.assert_allclose(got[:, 2:4], ref[:, 2:4], atol=1e-3)
        np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-5)
    assert sum(len(g) for g in batched) > 0
    # a (B,H,W) uint8 tensor is B grey images
    t = torch.from_numpy(np.stack([a[..., 0] for a in imgsA[:3]]))
    u = torch.from_numpy(np.stack([a[..., 0] for a in imgsB[:2]]
                                  + [imgsB[2]]))
    from_tensor = mt.predict(t, u)
    from_list = mt.predict(list(t.numpy()), list(u.numpy()))
    for a, b in zip(from_tensor, from_list):
        np.testing.assert_array_equal(a, b)


def test_matcher_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.LoftrMatcher(cfg=tl.LoftrConfig(**TINY))


def test_checkpoint_file_loads_as_reference(golden, tmp_path):
    _, sd = golden
    path = str(tmp_path / "loftr.ckpt")
    torch.save({"state_dict": {f"matcher.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    cfg = tl.LoftrConfig(**TINY)
    a = tl.LoftrMatcher(ckpt_path=path, cfg=cfg, device="cpu").net
    b = tl.load_reference_state_dict(sd, cfg)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    amp = tl.LoftrMatcher(ckpt_path=path, device="cpu",
                          cfg=dataclasses.replace(cfg, amp=True)).net
    assert {p.dtype for p in amp.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("over,size", [
    ({**TINY, "max_matches": 16}, 64), (TINY, 96), ({}, 400)],
    ids=["tiny64", "tiny96", "full400"])
def test_pair_flops_against_module_hooks(over, size):
    """The benchmark's `loftr_flops.pair_flops` against a count of every
    Conv2d and Linear call of one forward (forward hooks), plus the einsums
    and products that run outside modules, counted here from the shapes;
    at the full widths on 400x400 pairs also its pin of 404.27 GFLOP."""
    from perfbench.loftr_flops import pair_flops
    cfg = tl.LoftrConfig(**over)
    net = tl.init_loftr(cfg)
    counted = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            counted[0] += 2 * out.numel() * mod.in_channels * k
        else:
            counted[0] += 2 * out.numel() * mod.in_features

    for mod in net.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(hook)
    H = W = size
    with torch.no_grad():
        net(torch.rand(1, H, W), torch.rand(1, H, W))
    L = (H // 8) * (W // 8)
    K, ww = min(cfg.max_matches, L), cfg.fine_window ** 2

    def attn(Lq, S, d):
        return 2 * S * d * (d // cfg.nhead) + 2 * Lq * d \
            + 2 * Lq * d * (d // cfg.nhead)

    outside = (2 * cfg.n_coarse_layers * 2 * attn(L, L, cfg.d_coarse)
               + 2 * L * L * cfg.d_coarse
               + 2 * cfg.n_fine_layers * 2 * K * attn(ww, ww, cfg.d_fine)
               + 2 * K * ww * cfg.d_fine + 2 * K * ww * 2)
    got = pair_flops(dataclasses.asdict(cfg), H, W)["total"]
    assert got == counted[0] + outside
    if not over:
        assert round(got / 1e9, 2) == 404.27
