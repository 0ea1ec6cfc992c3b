"""LoFTR's forward in plain torch and float32, and the seeded weights that
stand in for a trained checkpoint.

LoFTR: Sun et al., "LoFTR: Detector-Free Local Feature Matching with
Transformers", CVPR 2021, arXiv:2104.00680; code zju3dv/LoFTR
(`src/loftr/`), the outdoor dual-softmax configuration that BundleSDF
loads from `outdoor_ds.ckpt` (BundleTrack/LoFTR, `loftr_wrapper.py`,
match threshold 0.2). The modules follow upstream's and carry its names,
so a state_dict in upstream's layout loads as it is:

- `backbone`: ResNet-FPN 8/2 (`resnet_fpn.py`), BasicBlocks with their
  BatchNorms in eval mode, bilinear upsampling with aligned corners, 1/8
  coarse features of width `d_coarse` and 1/2 fine ones of `d_fine`;
- `pos_encoding`: the 2D sine encoding with the released checkpoint's
  temperature (`temp_bug_fix` False: `-log(10000) / d_model // 2`);
- `loftr_coarse`, `loftr_fine`: (self, cross) encoder layers with elu+1
  linear attention (`linear_attention.py`), the cross layer sequential
  (feat1 attends to the updated feat0);
- coarse matching: dual softmax at `dsmax_temperature` over features
  scaled by 1/sqrt(d), threshold `match_thr`, `border_rm` cells masked
  on each border, mutual nearest neighbours (`coarse_matching.py`);
- `fine_preprocess`: `unfold` windows of `fine_window`^2 fine features
  around each match (zero padded), the coarse features of both cells
  projected and merged in (`fine_preprocess.py`);
- fine matching: softmax of the centre feature against the window at
  1/sqrt(d_fine), its expectation over the normalised grid
  (`fine_matching.py`).

Departures from upstream:

- the matches of a pair fill a static top-K of `max_matches` slots (1,024
  in the configuration), in descending confidence, ties to the lower
  cell first; a slot without a match has confidence 0. Upstream keeps
  every match, in cell order. A pair with more matches than slots keeps
  the K most confident; the fine stage runs on every slot;
- the pairs of a batch share one image size, and no mask is taken;
- where a row has two columns at its maximum, the first is taken (upstream
  takes the first one that is also its column's maximum);
- the positional encoding is computed at the feature map's size, not cut
  from a 256 x 256 table (the same values);
- kornia's grid and expectation are written out (the same arithmetic);
- no `std` of the fine heat map is returned, and nothing for training.

`forward` runs under `float32_matmuls()`, which turns TF32 off for
matmuls and cuDNN and restores both flags after.

This file imports nothing of the repository, so it can be copied beside
any program that it checks.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class Config:
    """The outdoor configuration's sizes (zju3dv/LoFTR
    `configs/loftr/outdoor/loftr_ds.py` over `src/config/default.py`)."""
    initial_dim: int = 128
    block_dims: tuple = (128, 196, 256)
    d_coarse: int = 256
    d_fine: int = 128
    nhead: int = 8
    n_coarse_layers: int = 4     # (self, cross) pairs
    n_fine_layers: int = 1
    fine_window: int = 5
    match_thr: float = 0.2
    dsmax_temperature: float = 0.1
    border_rm: int = 2
    max_matches: int = 1024
    fine_concat_coarse: bool = True


@contextlib.contextmanager
def float32_matmuls():
    """Matmuls and convolutions in full float32 (no TF32) for the block;
    the two flags are restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# backbone (resnet_fpn.py)
# ---------------------------------------------------------------------------

def conv1x1(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 1, stride=stride, padding=0, bias=False)


def conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride)
        self.conv2 = conv3x3(cout, cout)
        self.bn1 = nn.BatchNorm2d(cout)
        self.bn2 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.downsample = (None if stride == 1 else nn.Sequential(
            conv1x1(cin, cout, stride), nn.BatchNorm2d(cout)))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


def _outconv2(c, cout):
    return nn.Sequential(conv3x3(c, c), nn.BatchNorm2d(c), nn.LeakyReLU(),
                         conv3x3(c, cout))


class ResNetFPN_8_2(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d0, d1, d2 = cfg.block_dims
        self.conv1 = nn.Conv2d(1, cfg.initial_dim, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(cfg.initial_dim)
        self.relu = nn.ReLU()
        self.layer1 = nn.Sequential(BasicBlock(cfg.initial_dim, d0, 1),
                                    BasicBlock(d0, d0))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2), BasicBlock(d1, d1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2))
        self.layer3_outconv = conv1x1(d2, d2)
        self.layer2_outconv = conv1x1(d1, d2)
        self.layer2_outconv2 = _outconv2(d2, d1)
        self.layer1_outconv = conv1x1(d0, d1)
        self.layer1_outconv2 = _outconv2(d1, d0)

    def forward(self, x):
        x0 = self.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x0)                     # 1/2
        x2 = self.layer2(x1)                     # 1/4
        x3 = self.layer3(x2)                     # 1/8
        x3_out = self.layer3_outconv(x3)
        x3_up = F.interpolate(x3_out, scale_factor=2.0, mode="bilinear",
                              align_corners=True)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + x3_up)
        x2_up = F.interpolate(x2_out, scale_factor=2.0, mode="bilinear",
                              align_corners=True)
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + x2_up)
        return x3_out, x1_out


class PositionEncodingSine(nn.Module):
    def __init__(self, d_model):
        super().__init__()
        self.d_model = d_model

    def forward(self, x):
        """@x: (N,C,H,W) -> x + the encoding (position_encoding.py)."""
        d, (H, W) = self.d_model, x.shape[-2:]
        y = torch.ones(H, W).cumsum(0)[None]
        xs = torch.ones(H, W).cumsum(1)[None]
        div = torch.exp(torch.arange(0, d // 2, 2).float()
                        * (-math.log(10000.0) / d // 2))[:, None, None]
        pe = torch.zeros(d, H, W)
        pe[0::4] = torch.sin(xs * div)
        pe[1::4] = torch.cos(xs * div)
        pe[2::4] = torch.sin(y * div)
        pe[3::4] = torch.cos(y * div)
        return x + pe.to(x.device, x.dtype)[None]


# ---------------------------------------------------------------------------
# transformer (transformer.py, linear_attention.py)
# ---------------------------------------------------------------------------

def linear_attention(q, k, v, eps=1e-6):
    """@q: (N,L,H,D); @k, @v: (N,S,H,D)."""
    Q = F.elu(q) + 1
    K = F.elu(k) + 1
    S = v.shape[1]
    v = v / S
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * S


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model, nhead):
        super().__init__()
        self.dim = d_model // nhead
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(d_model * 2, d_model * 2, bias=False), nn.ReLU(),
            nn.Linear(d_model * 2, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, source):
        N = x.shape[0]
        q = self.q_proj(x).view(N, -1, self.nhead, self.dim)
        k = self.k_proj(source).view(N, -1, self.nhead, self.dim)
        v = self.v_proj(source).view(N, -1, self.nhead, self.dim)
        msg = linear_attention(q, k, v)
        msg = self.norm1(self.merge(msg.reshape(N, -1, self.nhead
                                                * self.dim)))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=2)))
        return x + msg


class LocalFeatureTransformer(nn.Module):
    def __init__(self, d_model, nhead, n_pairs):
        super().__init__()
        self.layer_names = ["self", "cross"] * n_pairs
        self.layers = nn.ModuleList(LoFTREncoderLayer(d_model, nhead)
                                    for _ in self.layer_names)

    def forward(self, feat0, feat1):
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                feat0 = layer(feat0, feat0)
                feat1 = layer(feat1, feat1)
            else:
                feat0 = layer(feat0, feat1)
                feat1 = layer(feat1, feat0)
        return feat0, feat1


class FinePreprocess(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.W = cfg.fine_window
        self.cat_c_feat = cfg.fine_concat_coarse
        if self.cat_c_feat:
            self.down_proj = nn.Linear(cfg.d_coarse, cfg.d_fine, bias=True)
            self.merge_feat = nn.Linear(2 * cfg.d_fine, cfg.d_fine,
                                        bias=True)

    def forward(self, feat_f0, feat_f1, feat_c0, feat_c1, b_ids, i_ids,
                j_ids, stride):
        """Windows (M,W*W,C) of both images around matches (b, i, j)."""
        W = self.W
        C = feat_f0.shape[1]

        def windows(f):
            u = F.unfold(f, kernel_size=(W, W), stride=stride,
                         padding=W // 2)                   # n (c ww) l
            return u.view(f.shape[0], C, W * W, -1).permute(0, 3, 2, 1)

        w0 = windows(feat_f0)[b_ids, i_ids]
        w1 = windows(feat_f1)[b_ids, j_ids]
        if not self.cat_c_feat:
            return w0, w1
        c = self.down_proj(torch.cat([feat_c0[b_ids, i_ids],
                                      feat_c1[b_ids, j_ids]], 0))
        cf = self.merge_feat(torch.cat([torch.cat([w0, w1], 0),
                                        c[:, None].expand(-1, W * W, -1)],
                                       -1))
        return torch.chunk(cf, 2, dim=0)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class LoFTR(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN_8_2(cfg)
        self.pos_encoding = PositionEncodingSine(cfg.d_coarse)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.d_coarse, cfg.nhead, cfg.n_coarse_layers)
        self.fine_preprocess = FinePreprocess(cfg)
        self.loftr_fine = LocalFeatureTransformer(
            cfg.d_fine, cfg.nhead, cfg.n_fine_layers)

    def coarse_match(self, feat_c0, feat_c1, hc, wc):
        """(conf_matrix (N,L,L), the kept matches' (b, i, j, conf), each
        (N*K,), and K): dual softmax, threshold, border, mutual nearest
        neighbours, then each pair's K most confident cells."""
        cfg = self.cfg
        N, L, C = feat_c0.shape
        f0, f1 = feat_c0 / C ** 0.5, feat_c1 / C ** 0.5
        sim = torch.einsum("nlc,nsc->nls", f0, f1) / cfg.dsmax_temperature
        conf = F.softmax(sim, 1) * F.softmax(sim, 2)
        mask = conf > cfg.match_thr
        m = mask.view(N, hc, wc, hc, wc)
        b = cfg.border_rm
        if b > 0:
            m[:, :b] = False
            m[:, :, :b] = False
            m[:, :, :, :b] = False
            m[:, :, :, :, :b] = False
            m[:, -b:] = False
            m[:, :, -b:] = False
            m[:, :, :, -b:] = False
            m[:, :, :, :, -b:] = False
        mask = (mask & (conf == conf.max(dim=2, keepdim=True).values)
                & (conf == conf.max(dim=1, keepdim=True).values))
        mask_v, all_j = mask.max(dim=2)
        row_conf = torch.where(
            mask_v, conf.gather(2, all_j[..., None])[..., 0],
            torch.zeros((), dtype=conf.dtype, device=conf.device))
        K = min(cfg.max_matches, L)
        top, i_ids = torch.sort(row_conf, dim=1, descending=True,
                                stable=True)
        top, i_ids = top[:, :K], i_ids[:, :K]
        j_ids = all_j.gather(1, i_ids)
        b_ids = torch.arange(N, device=conf.device)[:, None].expand(N, K)
        return conf, (b_ids.reshape(-1), i_ids.reshape(-1),
                      j_ids.reshape(-1), top.reshape(-1)), K

    def forward(self, img0, img1):
        """@img0, @img1: (N,H,W) float in [0,1], H and W divisible by 8.
        Returns {uv0, uv1: (N,K,2) pixels, conf: (N,K), 0 on an empty
        slot, conf_matrix: (N,L,L)}, all float32."""
        with float32_matmuls():
            return self._forward(img0.float(), img1.float())

    def _forward(self, img0, img1):
        cfg = self.cfg
        N, H, W = img0.shape
        feat_c, feat_f = self.backbone(torch.cat([img0, img1])[:, None])
        hc, wc = feat_c.shape[-2:]
        hf = feat_f.shape[-2]
        fc = self.pos_encoding(feat_c).flatten(2).transpose(1, 2)
        fc0, fc1 = self.loftr_coarse(fc[:N], fc[N:])
        conf, (b_ids, i_ids, j_ids, mconf), K = self.coarse_match(
            fc0, fc1, hc, wc)
        scale = H / hc
        uv0_c = torch.stack([i_ids % wc, i_ids // wc], 1).float() * scale
        uv1_c = torch.stack([j_ids % wc, j_ids // wc], 1).float() * scale

        w0, w1 = self.fine_preprocess(feat_f[:N], feat_f[N:], fc0, fc1,
                                      b_ids, i_ids, j_ids, hf // hc)
        w0, w1 = self.loftr_fine(w0, w1)
        M, WW, C = w0.shape
        Wn = cfg.fine_window
        sim = torch.einsum("mc,mrc->mr", w0[:, WW // 2, :], w1)
        heat = torch.softmax(sim / C ** 0.5, dim=1)
        lin = torch.linspace(-1.0, 1.0, Wn, device=heat.device)
        gy, gx = torch.meshgrid(lin, lin, indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(WW, 2)
        expect = (heat[..., None] * grid).sum(1)
        uv1_f = uv1_c + expect * (Wn // 2) * (H / hf)
        return {"uv0": uv0_c.view(N, K, 2), "uv1": uv1_f.view(N, K, 2),
                "conf": mconf.view(N, K), "conf_matrix": conf}


# ---------------------------------------------------------------------------
# seeded weights in upstream's checkpoint layout
# ---------------------------------------------------------------------------

def seeded_state_dict(cfg: Config = Config(), seed: int = 0,
                      gains: dict | None = None) -> dict:
    """A state_dict of `LoFTR(cfg)` in upstream's layout (BatchNorm weight,
    bias, running_mean, running_var and num_batches_tracked included): its
    convs and linears drawn from one torch generator seeded with @seed,
    module by module in the network's order, convs N(0, 2 / (k*k*cout)),
    linears N(0, 1 / cin); biases 0, BatchNorm and LayerNorm at unit scale,
    zero shift and unit variance. @gains: {key: factor} multiplied into
    those tensors after the draw.

    Drawn weights give coarse features that share most of their direction
    from cell to cell, so the dual softmax is nearly flat and finds a few
    matches a pair. A gain on the coarse output conv
    (`backbone.layer3_outconv.weight`) lets the image's content outweigh
    the positional encoding, and a gain on the last coarse layer's
    `norm2.weight` makes every coarse feature that layer's LayerNorm output
    (one length for all cells) times the gain, so the similarity peaks on
    content as a trained net's does and a tracker gets a matcher's load of
    matches. The compute does not change."""
    gen = torch.Generator().manual_seed(int(seed))
    net = LoFTR(cfg)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan = (m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                       / 2.0 if isinstance(m, nn.Conv2d) else m.in_features)
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan))
                if m.bias is not None:
                    m.bias.zero_()
    sd = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for k, g in (gains or {}).items():
        sd[k] = sd[k] * float(g)
    return sd


def load(sd: dict, cfg: Config = Config()) -> LoFTR:
    """The network in eval mode with the weights of @sd (upstream's
    layout, no `matcher.` prefix), loaded strictly."""
    net = LoFTR(cfg)
    net.load_state_dict(sd, strict=True)
    return net.eval()


def write_checkpoint(path: str, sd: dict):
    """Write @sd as `outdoor_ds.ckpt` is laid out: {"state_dict":
    {"matcher.<name>": tensor}}."""
    torch.save({"state_dict": {f"matcher.{k}": v for k, v in sd.items()}},
               path)
