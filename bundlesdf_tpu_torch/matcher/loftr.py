"""LoFTR dense matcher in PyTorch.

Port of `bundlesdf_tpu/matcher/loftr.py`, itself a re-implementation of
the reference network (`BundleTrack/LoFTR/src/loftr/`): ResNet-FPN 8/2
backbone (1/8 coarse 256-d, 1/2 fine 128-d, resnet_fpn.py:44-120), 2D
sine positional encoding (position_encoding.py), 4 x (self, cross)
linear-attention layers (transformer.py, linear_attention.py:14-46),
dual-softmax coarse matching with mutual nearest neighbours
(coarse_matching.py:112-196), 5x5 fine windows with the coarse feature
concatenated (fine_preprocess.py), 1 x (self, cross) fine layer and the
expectation-based sub-pixel refinement (fine_matching.py).

The modules are named after the reference tree (`backbone`,
`pos_encoding`, `loftr_coarse`, `fine_preprocess`, `loftr_fine`); each
BatchNorm is folded into the conv before it. The forward is batched over
pairs and returns the JAX package's static contract: `K = min(max_matches,
L)` top-K slots per pair, `conf` 0 on an empty slot. Weights come from the
reference checkpoint's keys (`load_reference_state_dict`) or from the JAX
package's parameter tree (`params_from_jax`); both give the same module.

Under `cfg.amp` the weights and the input are bfloat16 (the reference
autocasts to fp16); LayerNorm statistics, the dual softmax and the fine
expectation stay float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bundlesdf_tpu_torch import resolve_device
from bundlesdf_tpu_torch.matcher.orb import rgb_to_gray
from bundlesdf_tpu_torch.utils.transfer import HostPull


@dataclass(frozen=True)
class LoftrConfig:
    initial_dim: int = 128
    block_dims: tuple = (128, 196, 256)
    d_coarse: int = 256
    d_fine: int = 128
    nhead: int = 8
    n_coarse_layers: int = 4     # x (self, cross)
    n_fine_layers: int = 1
    fine_window: int = 5
    match_thr: float = 0.2       # loftr_wrapper.py:21 overrides to 0.2
    dsmax_temperature: float = 0.1
    border_rm: int = 2
    max_matches: int = 1024      # static top-K slots
    fine_concat_coarse: bool = True
    # bf16 weights and activations, matching math in f32 (the reference
    # wrapper runs the net under fp16 autocast, loftr_wrapper.py:43-56)
    amp: bool = False


def _fuse_bn(gamma, beta, mean, var, eps=1e-5):
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


# ---------------------------------------------------------------------------
# backbone: ResNet-FPN 8_2 (ref resnet_fpn.py)
# ---------------------------------------------------------------------------

def _conv(cin, cout, k, stride=1, bn=True):
    """A conv with torch's symmetric k//2 padding; a folded BatchNorm is
    its bias."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bn)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.conv2 = _conv(cout, cout, 3)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride))
                           if stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = self.conv2(y)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _outconv2(cin, cmid, cout):
    # ref: Sequential(conv3x3, BatchNorm, LeakyReLU, conv3x3); the norm is
    # folded into conv 0, so the indices of the convs stay 0 and 3
    return nn.Sequential(_conv(cin, cmid, 3), nn.Identity(),
                         nn.LeakyReLU(0.01), _conv(cmid, cout, 3, bn=False))


class ResNetFPN_8_2(nn.Module):
    def __init__(self, cfg: LoftrConfig):
        super().__init__()
        d0, d1, d2 = cfg.block_dims
        di = cfg.initial_dim
        self.conv1 = _conv(1, di, 7, 2)
        self.layer1 = nn.Sequential(BasicBlock(di, d0), BasicBlock(d0, d0))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2), BasicBlock(d1, d1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2))
        self.layer3_outconv = _conv(d2, d2, 1, bn=False)
        self.layer2_outconv = _conv(d1, d2, 1, bn=False)
        self.layer2_outconv2 = _outconv2(d2, d2, d1)
        self.layer1_outconv = _conv(d0, d1, 1, bn=False)
        self.layer1_outconv2 = _outconv2(d1, d1, d0)

    def forward(self, x):
        """@x: (N,1,H,W). Returns (coarse (N,256,H/8,W/8), fine
        (N,128,H/2,W/2)). Ref resnet_fpn.py:101-120."""
        x0 = F.relu(self.conv1(x))                                  # 1/2
        x1 = self.layer1(x0)                                        # 1/2
        x2 = self.layer2(x1)                                        # 1/4
        x3 = self.layer3(x2)                                        # 1/8
        x3_out = self.layer3_outconv(x3)
        x3_up = F.interpolate(x3_out, scale_factor=2.0, mode="bilinear",
                              align_corners=True)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + x3_up)
        x2_up = F.interpolate(x2_out, scale_factor=2.0, mode="bilinear",
                              align_corners=True)
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + x2_up)
        return x3_out, x1_out


# ---------------------------------------------------------------------------
# positional encoding (ref position_encoding.py, temp_bug_fix=False per
# cvpr_ds_config.py:28: the released checkpoint was trained with it)
# ---------------------------------------------------------------------------

def sine_pos_encoding(d_model, H, W):
    """(H,W,d_model) float32 numpy, the reference's buggy temperature
    `-log(10000) / d_model // 2` kept."""
    pe = np.zeros((H, W, d_model), np.float32)
    y = np.arange(1, H + 1, dtype=np.float32)[:, None]
    x = np.arange(1, W + 1, dtype=np.float32)[None, :]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model // 2))
    pe[..., 0::4] = np.sin(x[..., None] * div)
    pe[..., 1::4] = np.cos(x[..., None] * div)
    pe[..., 2::4] = np.sin(y[..., None] * div)
    pe[..., 3::4] = np.cos(y[..., None] * div)
    return pe


class PositionEncodingSine(nn.Module):
    def __init__(self, d_model):
        super().__init__()
        self.d_model = d_model
        self._cache = {}

    def forward(self, x):
        """@x: (N,C,H,W) -> x + pe."""
        key = (x.shape[-2], x.shape[-1], x.device, x.dtype)
        pe = self._cache.get(key)
        if pe is None:
            pe = torch.from_numpy(sine_pos_encoding(
                self.d_model, *key[:2])).permute(2, 0, 1).to(x.device,
                                                              x.dtype)
            self._cache[key] = pe
        return x + pe


# ---------------------------------------------------------------------------
# transformer: linear attention encoder layers (ref transformer.py)
# ---------------------------------------------------------------------------

def linear_attention(q, k, v, eps=1e-6):
    """elu+1 feature-map linear attention (ref linear_attention.py:14-46).
    @q: (N,L,H,D); @k,@v: (N,S,H,D)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    S = v.shape[1]
    v = v / S
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * S


class LayerNorm32(nn.Module):
    """LayerNorm whose statistics are float32 whatever the input's dtype
    (torch autocast keeps LayerNorm in fp32); the output takes the input's
    dtype."""

    def __init__(self, d, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(d_model * 2, d_model * 2,
                                           bias=False), nn.ReLU(),
                                 nn.Linear(d_model * 2, d_model, bias=False))
        self.norm1 = LayerNorm32(d_model)
        self.norm2 = LayerNorm32(d_model)

    def forward(self, x, source):
        """Ref transformer.py LoFTREncoderLayer.forward."""
        N, L, C = x.shape
        D = C // self.nhead
        q = self.q_proj(x).reshape(N, L, self.nhead, D)
        k = self.k_proj(source).reshape(N, -1, self.nhead, D)
        v = self.v_proj(source).reshape(N, -1, self.nhead, D)
        msg = linear_attention(q, k, v).reshape(N, L, C)
        msg = self.norm1(self.merge(msg))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + msg


class LocalFeatureTransformer(nn.Module):
    def __init__(self, d_model, nhead, n_pairs):
        super().__init__()
        self.layers = nn.ModuleList(LoFTREncoderLayer(d_model, nhead)
                                    for _ in range(2 * n_pairs))

    def forward(self, feat0, feat1):
        """Alternating (self, cross) layers (ref transformer.py:91-98).
        The cross step is sequential: feat1 attends to the already updated
        feat0. A self layer runs both sides as one batch."""
        N = feat0.shape[0]
        for i, layer in enumerate(self.layers):
            if i % 2 == 0:
                both = torch.cat([feat0, feat1])
                both = layer(both, both)
                feat0, feat1 = both[:N], both[N:]
            else:
                feat0 = layer(feat0, feat1)
                feat1 = layer(feat1, feat0)
        return feat0, feat1


class FinePreprocess(nn.Module):
    def __init__(self, cfg: LoftrConfig):
        super().__init__()
        self.down_proj = nn.Linear(cfg.d_coarse, cfg.d_fine, bias=True)
        self.merge_feat = nn.Linear(2 * cfg.d_fine, cfg.d_fine, bias=True)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class LoFTR(nn.Module):
    def __init__(self, cfg: LoftrConfig = LoftrConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN_8_2(cfg)
        self.pos_encoding = PositionEncodingSine(cfg.d_coarse)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.d_coarse, cfg.nhead, cfg.n_coarse_layers)
        self.fine_preprocess = (FinePreprocess(cfg)
                                if cfg.fine_concat_coarse else None)
        self.loftr_fine = LocalFeatureTransformer(
            cfg.d_fine, cfg.nhead, cfg.n_fine_layers)
        self._border = {}

    @property
    def dtype(self):
        return self.backbone.conv1.weight.dtype

    def _border_cells(self, hc, wc, device):
        key = (hc, wc, device)
        if key not in self._border:
            b = self.cfg.border_rm
            iy = torch.arange(hc * wc, device=device) // wc
            ix = torch.arange(hc * wc, device=device) % wc
            self._border[key] = ((iy < b) | (iy >= hc - b)
                                 | (ix < b) | (ix >= wc - b))
        return self._border[key]

    def forward(self, img0, img1, debug=False):
        """Match pairs of grey images.

        @img0/@img1: (N,H,W) float32 in [0,1], H and W divisible by 8.
        Returns a dict of static top-K slots: uv0, uv1 (N,K,2) pixel
        coordinates and conf (N,K), 0 on an empty slot. @debug adds the
        dense coarse confidence matrix (N,L,S)."""
        cfg = self.cfg
        N, H, W = img0.shape
        hc, wc = H // 8, W // 8
        hf, wf = H // 2, W // 2
        stride = hf // hc
        Wwin = cfg.fine_window
        r = Wwin // 2
        dev = img0.device
        x = torch.cat([img0, img1])[:, None].to(self.dtype)
        feat_c, feat_f = self.backbone(x)
        feat_c = self.pos_encoding(feat_c).flatten(2).transpose(1, 2)
        fc0, fc1 = self.loftr_coarse(feat_c[:N], feat_c[N:])

        # dual-softmax confidence in f32 (ref coarse_matching.py:112-119)
        f0 = fc0.float() / cfg.d_coarse ** 0.5
        f1 = fc1.float() / cfg.d_coarse ** 0.5
        sim = torch.bmm(f0, f1.transpose(1, 2)) / cfg.dsmax_temperature
        conf = torch.softmax(sim, dim=1)
        conf.mul_(torch.softmax(sim, dim=2))
        del sim

        # threshold, border removal, mutual nearest neighbour (ref
        # :171-189) evaluated at each row's best column: the row maximum
        # is that column's entry, so the pair is kept where it is also the
        # column maximum
        L = hc * wc
        border = self._border_cells(hc, wc, dev)
        j_best = torch.argmax(conf, dim=2)                       # (N,L)
        best = conf.gather(2, j_best[..., None])[..., 0]
        col_max = conf.amax(dim=1).gather(1, j_best)
        ok = ((best > cfg.match_thr) & ~border[None] & ~border[j_best]
              & (best == col_max))
        row_conf = torch.where(ok, best, torch.zeros_like(best))

        # static top-K, ties to the lower index first as lax.top_k
        K = min(cfg.max_matches, L)
        top_conf, i_ids = torch.sort(row_conf, dim=1, descending=True,
                                     stable=True)
        top_conf, i_ids = top_conf[:, :K], i_ids[:, :K]
        j_ids = j_best.gather(1, i_ids)

        # coarse pixel coordinates (scale 8)
        uv0_c = torch.stack([(i_ids % wc) * 8, (i_ids // wc) * 8],
                            -1).float()
        uv1_c = torch.stack([(j_ids % wc) * 8, (j_ids // wc) * 8],
                            -1).float()

        # fine windows: Wwin x Wwin crops around (cell * stride) of the
        # fine maps, zero outside the image (ref fine_preprocess.py:40-47,
        # F.unfold with zero padding)
        Cf = feat_f.shape[1]
        ff = F.pad(feat_f.permute(0, 2, 3, 1), (0, 0, r, r, r, r))
        pw = wf + 2 * r
        ff = ff.reshape(2 * N, (hf + 2 * r) * pw, Cf)
        offs = torch.arange(-r, r + 1, device=dev)
        win_off = ((offs[:, None] + r) * pw + (offs[None, :] + r)).reshape(-1)

        def crop(fmap, ids):
            base = (ids // wc) * stride * pw + (ids % wc) * stride
            flat = (base[..., None] + win_off).reshape(N, -1)
            rows = torch.arange(N, device=dev)[:, None]
            return fmap[rows, flat].reshape(N, K, Wwin * Wwin, Cf)

        win0 = crop(ff[:N], i_ids)                            # (N,K,25,Cf)
        win1 = crop(ff[N:], j_ids)
        if self.fine_preprocess is not None:
            rows = torch.arange(N, device=dev)[:, None]
            ctx = torch.cat([fc0[rows, i_ids], fc1[rows, j_ids]], dim=1)
            ctx = self.fine_preprocess.down_proj(ctx)        # (N,2K,Cf)
            wins = torch.cat([win0, win1], dim=1)            # (N,2K,25,Cf)
            merged = self.fine_preprocess.merge_feat(torch.cat(
                [wins, ctx[:, :, None].expand_as(wins)], dim=-1))
            win0, win1 = merged[:, :K], merged[:, K:]

        w0, w1 = self.loftr_fine(win0.reshape(N * K, -1, Cf),
                                 win1.reshape(N * K, -1, Cf))

        # expectation sub-pixel refinement (ref fine_matching.py:42-60)
        center = w0[:, (Wwin * Wwin) // 2, :]
        sim_f = torch.einsum("kc,krc->kr", center, w1).float() \
            / cfg.d_fine ** 0.5
        heat = torch.softmax(sim_f, dim=-1)
        dy, dx = torch.meshgrid(offs, offs, indexing="ij")
        grid = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1).float() / r
        expect = (heat @ grid).reshape(N, K, 2)
        scale_f = H // hf
        uv1_f = uv1_c + expect * r * scale_f

        out = {"uv0": uv0_c, "uv1": uv1_f, "conf": top_conf}
        if debug:
            out["conf_matrix"] = conf
        return out


# ---------------------------------------------------------------------------
# weights: random init, the reference checkpoint, the JAX parameter tree
# ---------------------------------------------------------------------------

def _conv_names():
    """(module key, reference conv key, reference BatchNorm key or None,
    JAX tree path) of every conv in the backbone."""
    out = [("backbone.conv1", "backbone.conv1", "backbone.bn1", ("conv1",))]
    for lay in ("layer1", "layer2", "layer3"):
        for i in (0, 1):
            p, j = f"backbone.{lay}.{i}", f"{lay}_{i}"
            out += [(f"{p}.conv1", f"{p}.conv1", f"{p}.bn1", (j, "conv1")),
                    (f"{p}.conv2", f"{p}.conv2", f"{p}.bn2", (j, "conv2"))]
            if lay != "layer1" and i == 0:
                out.append((f"{p}.downsample.0", f"{p}.downsample.0",
                            f"{p}.downsample.1", (j, "down")))
    for lay in ("layer3", "layer2", "layer1"):
        p = f"backbone.{lay}_outconv"
        out.append((p, p, None, (f"{lay}_outconv",)))
    for lay in ("layer2", "layer1"):
        p = f"backbone.{lay}_outconv2"
        out += [(f"{p}.0", f"{p}.0", f"{p}.1", (f"{lay}_outconv2_0",)),
                (f"{p}.3", f"{p}.3", None, (f"{lay}_outconv2_1",))]
    return out


def _module(state, cfg: LoftrConfig):
    net = LoFTR(cfg)
    net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in state.items()}, strict=True)
    net.eval()
    return net.to(torch.bfloat16) if cfg.amp else net


def _encoder_keys(cfg: LoftrConfig):
    names = [f"loftr_coarse.layers.{i}"
             for i in range(2 * cfg.n_coarse_layers)]
    names += [f"loftr_fine.layers.{i}" for i in range(2 * cfg.n_fine_layers)]
    return names


_LINEARS = ("q_proj", "k_proj", "v_proj", "merge", "mlp.0", "mlp.2")


def load_reference_state_dict(sd, cfg: LoftrConfig = LoftrConfig()):
    """The module with the weights of a reference checkpoint's
    state_dict (`outdoor_ds.ckpt`'s `state_dict` with the `matcher.`
    prefix stripped, as loftr_wrapper.py does): each BatchNorm folded into
    its conv (`_fuse_bn`, eps 1e-5). Bfloat16 under `cfg.amp`."""
    def t(name):
        v = sd[name]
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    state = {}
    for key, ref, bn, _ in _conv_names():
        w = t(f"{ref}.weight")
        if bn is not None:
            scale, bias = _fuse_bn(t(f"{bn}.weight"), t(f"{bn}.bias"),
                                   t(f"{bn}.running_mean"),
                                   t(f"{bn}.running_var"))
            w = w * scale[:, None, None, None]
            state[f"{key}.bias"] = bias
        state[f"{key}.weight"] = w
    for name in _encoder_keys(cfg):
        for lin in _LINEARS:
            state[f"{name}.{lin}.weight"] = t(f"{name}.{lin}.weight")
        for nrm in ("norm1", "norm2"):
            for p in ("weight", "bias"):
                state[f"{name}.{nrm}.{p}"] = t(f"{name}.{nrm}.{p}")
    if cfg.fine_concat_coarse:
        for lin in ("down_proj", "merge_feat"):
            for p in ("weight", "bias"):
                state[f"fine_preprocess.{lin}.{p}"] = t(
                    f"fine_preprocess.{lin}.{p}")
    return _module(state, cfg)


def params_from_jax(params, cfg: LoftrConfig = LoftrConfig()):
    """The module with the weights of the JAX package's parameter tree
    (`init_loftr_params` / `convert_torch_state_dict`, leaves as numpy
    arrays): conv HWIO -> OIHW with the folded BatchNorm scale multiplied
    in, linear IO -> OI. Bfloat16 under `cfg.amp`."""
    def a(x):
        return np.asarray(x, np.float32)

    state = {}
    for key, _, bn, path in _conv_names():
        p = params["backbone"]
        for name in path:
            p = p[name]
        w = np.transpose(a(p["w"]), (3, 2, 0, 1))
        if bn is not None:
            w = w * a(p["bn_scale"])[:, None, None, None]
            state[f"{key}.bias"] = a(p["bn_bias"])
        state[f"{key}.weight"] = w
    layers = list(params["coarse_layers"]) + list(params["fine_layers"])
    jax_lin = ("q_proj", "k_proj", "v_proj", "merge", "mlp_0", "mlp_1")
    for name, p in zip(_encoder_keys(cfg), layers):
        for lin, jl in zip(_LINEARS, jax_lin):
            state[f"{name}.{lin}.weight"] = a(p[jl]["w"]).T
        for nrm in ("norm1", "norm2"):
            state[f"{name}.{nrm}.weight"] = a(p[nrm]["g"])
            state[f"{name}.{nrm}.bias"] = a(p[nrm]["b"])
    if cfg.fine_concat_coarse:
        for lin in ("down_proj", "merge_feat"):
            state[f"fine_preprocess.{lin}.weight"] = a(params[lin]["w"]).T
            state[f"fine_preprocess.{lin}.bias"] = a(params[lin]["b"])
    return _module(state, cfg)


def init_loftr(cfg: LoftrConfig = LoftrConfig(), seed=0):
    """A module with seeded random weights, drawn as the JAX package's
    `init_loftr_params` draws them (convs N(0, 2 / (k*k*cout)), linears
    N(0, 1 / cin), unit norms, zero biases) from torch's generator."""
    gen = torch.Generator().manual_seed(seed)
    net = LoFTR(cfg)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                m.weight.normal_(generator=gen).mul_(
                    math.sqrt(2.0 / (kh * kw * m.out_channels)))
            elif isinstance(m, nn.Linear):
                m.weight.normal_(generator=gen).mul_(
                    math.sqrt(1.0 / m.in_features))
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
    net.eval()
    return net.to(torch.bfloat16) if cfg.amp else net


def load_checkpoint(path, cfg: LoftrConfig = LoftrConfig()):
    """The module of a reference checkpoint file
    `{"state_dict": {"matcher.<name>": tensor}}` (ref loftr_wrapper.py:
    19-27). Only tensors are unpickled."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.replace("matcher.", "", 1): v
          for k, v in ckpt["state_dict"].items()}
    return load_reference_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# the matcher with the LoftrRunner contract (ref loftr_wrapper.py:19-82)
# ---------------------------------------------------------------------------

class LoftrMatcher:
    """predict(rgbAs, rgbBs) -> list of (N,5) float32 [uA,vA,uB,vB,conf].

    Pairs of one call are grouped by image shape and matched in batches of
    at most @max_batch pairs (the reference wrapper's batch of 64); the
    results of the whole call come to the host in one pull."""

    def __init__(self, params=None, ckpt_path=None,
                 cfg: LoftrConfig = LoftrConfig(), seed=0, device="cuda",
                 max_batch=64):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        if params is not None:
            net = params_from_jax(params, cfg)
        elif ckpt_path is not None:
            net = load_checkpoint(ckpt_path, cfg)
        else:
            net = init_loftr(cfg, seed)
        self.net = net.to(self.device)

    def _to_gray(self, img):
        """(H,W) or (H,W,3) uint8, numpy or torch -> (H8,W8) uint8 on the
        matcher's device, cropped to a multiple of 8."""
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        img = img.to(self.device)
        if img.ndim == 3:
            img = rgb_to_gray(img)
        return img[:img.shape[0] // 8 * 8, :img.shape[1] // 8 * 8]

    @torch.inference_mode()
    def predict(self, rgbAs, rgbBs):
        """@rgbAs/@rgbBs: sequences of (H,W[,3]) uint8 images (numpy
        arrays or tensors; a (B,H,W) uint8 tensor is a sequence of B grey
        images)."""
        n = len(rgbAs)
        if n == 0:
            return []
        grayA = [self._to_gray(i) for i in rgbAs]
        grayB = [self._to_gray(i) for i in rgbBs]
        by_shape = {}
        for i in range(n):
            sh = (tuple(grayA[i].shape), tuple(grayB[i].shape))
            by_shape.setdefault(sh, []).append(i)
        chunks, results = [], {}
        for ids in by_shape.values():
            for s in range(0, len(ids), self.max_batch):
                chunk = ids[s:s + self.max_batch]
                a = torch.stack([grayA[i] for i in chunk]).float() / 255.0
                b = torch.stack([grayB[i] for i in chunk]).float() / 255.0
                res = self.net(a, b)
                c = len(chunks)
                results.update({f"{k}{c}": res[k]
                                for k in ("uv0", "uv1", "conf")})
                chunks.append(chunk)
        host = HostPull(results, "loftr").get()
        out = [None] * n
        for c, chunk in enumerate(chunks):
            uv0, uv1, conf = host[f"uv0{c}"], host[f"uv1{c}"], host[f"conf{c}"]
            for k, i in enumerate(chunk):
                keep = conf[k] > 0
                out[i] = np.concatenate(
                    [uv0[k][keep], uv1[k][keep], conf[k][keep][:, None]],
                    axis=-1).astype(np.float32)
        return out
