"""The work of one LoFTR pair's forward, counted from the network's shapes.

Multiply-adds times 2, by stage, for a pair of H x W images: the ResNet-FPN
8/2 backbone over both images, the coarse transformer's (self, cross)
layers at 1/8, the dual softmax's similarity, and the fine stage over
every one of the `max_matches` slots, full or not (the port runs all of
them). The sizes come from a dict with the keys of the port's
`LoftrConfig` and of `reference/loftr_plain.py::Config`.
"""
from __future__ import annotations


def pair_flops(cfg: dict, H: int, W: int) -> dict:
    """{stage: FLOPs, "total": their sum} of one pair's forward."""
    d0, d1, d2 = cfg["block_dims"]
    di = cfg["initial_dim"]
    h2, h4, h8 = (H // 2) * (W // 2), (H // 4) * (W // 4), (H // 8) * (W // 8)

    def conv(cin, cout, k, px):
        return 2 * cin * cout * k * k * px

    backbone = (
        conv(1, di, 7, h2) + conv(di, d0, 3, h2) + 3 * conv(d0, d0, 3, h2)
        + conv(d0, d1, 3, h4) + conv(d1, d1, 3, h4) + conv(d0, d1, 1, h4)
        + 2 * conv(d1, d1, 3, h4)
        + conv(d1, d2, 3, h8) + conv(d2, d2, 3, h8) + conv(d1, d2, 1, h8)
        + 2 * conv(d2, d2, 3, h8)
        + conv(d2, d2, 1, h8) + conv(d1, d2, 1, h4) + conv(d2, d2, 3, h4)
        + conv(d2, d1, 3, h4) + conv(d0, d1, 1, h2) + conv(d1, d1, 3, h2)
        + conv(d1, d0, 3, h2))

    def layer(L, S, d):
        """One encoder layer over L query rows and S source rows: the q
        and merge projections over L, k and v over S, the linear
        attention's KV, normaliser and output, and the MLP over [x, msg]."""
        D = d // cfg["nhead"]
        proj = 2 * L * d * d + 2 * 2 * S * d * d + 2 * L * d * d
        attn = 2 * S * d * D + 2 * L * d + 2 * L * d * D
        mlp = 2 * L * (2 * d) * (2 * d) + 2 * L * (2 * d) * d
        return proj + attn + mlp

    L = h8
    K = min(cfg["max_matches"], L)
    ww = cfg["fine_window"] ** 2
    dc, df = cfg["d_coarse"], cfg["d_fine"]
    coarse = 2 * cfg["n_coarse_layers"] * 2 * layer(L, L, dc)
    dual = 2 * L * L * dc
    fine = (2 * cfg["n_fine_layers"] * 2 * K * layer(ww, ww, df)
            + 2 * K * 2 * dc * df            # down_proj of both cells
            + 2 * K * ww * 2 * (2 * df) * df  # merge_feat of both windows
            + 2 * K * ww * df + 2 * K * ww * 2)  # similarity, expectation
    out = {"backbone": 2 * backbone, "coarse_transformer": coarse,
           "dual_softmax": dual, "fine": fine}
    out["total"] = sum(out.values())
    return out
