"""The yardstick's peaks and the work of the NOF step, counted from the
configuration's shapes.

Peaks of one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W power limit: 989 TFLOP/s in bf16, 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM. A card set below 700 W
reaches less; the result's `device.kind` and the power limit printed on
standard error say which card ran.
"""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def grid_layout(n_levels, base_res, finest_res, log2_hashmap_size):
    """Per level (res, n_rows) of the flat hash-grid table: resolution
    floor(base * b**l), dense levels (res+1)^3 rows, hashed levels 2^T."""
    b = (1.0 if n_levels == 1 else
         math.exp((math.log(finest_res) - math.log(base_res))
                  / (n_levels - 1)))
    T = 1 << log2_hashmap_size
    out = []
    for level in range(n_levels):
        res = int(math.floor(base_res * b ** level))
        dense = (res + 1) ** 3 <= T
        out.append((res, (res + 1) ** 3 if dense else T))
    return out


def step_shapes(cfg: dict) -> dict:
    """The NOF step's sizes from a NOF config (config.yml's keys): rays,
    samples a ray, grid levels and channels, table rows, MLP widths."""
    S = (int(cfg["N_samples"]) + int(cfg["N_samples_around_depth"])
         + int(cfg.get("N_importance", 0)) * int(cfg.get("N_importance_iter",
                                                         1)))
    L, C = int(cfg["num_levels"]), int(cfg["feature_grid_dim"])
    layout = grid_layout(L, int(cfg["base_res"]), int(cfg["finest_res"]),
                         int(cfg["log2_hashmap_size"]))
    view = (int(cfg["multires_views"]) ** 2 if int(cfg["use_viewdirs"])
            else 0) + int(cfg["frame_features"])
    return {"rays": int(cfg["N_rand"]), "samples": S, "levels": L,
            "channels": C, "rows": sum(n for _, n in layout),
            "sigma": [L * C, 64, 16], "color": [view + 15, 64, 64, 3],
            "amp": bool(cfg.get("amp", True))}


def nof_step_flops(cfg: dict) -> float:
    """Model FLOPs of one NOF training step: the two MLPs' and the
    hash-grid interpolation's forward and backward over every sample of
    the batch, whatever implements them. A dense layer of n_in x n_out
    costs 2 n_in n_out a point forward and twice that backward (the
    input's and the weight's gradients); the interpolation costs a
    multiply-add per corner, channel and level forward, and the same again
    for each of its two gradients (the table's and the weights')."""
    s = step_shapes(cfg)
    points = s["rays"] * s["samples"]
    mlp = sum(2 * a * b for net in (s["sigma"], s["color"])
              for a, b in zip(net, net[1:]))
    interp = 2 * 8 * s["channels"] * s["levels"]
    return float(points * 3 * (mlp + interp))


def scatter_bound_s(cfg: dict) -> float:
    """Least time of the hash-grid backward's row scatter on one H100: the
    M values (bf16 under amp, else float32) and their int32 row ids read
    once and the float32 output (n_rows x C) written once, at the HBM rate,
    or the M*C float32 adds at the float32 peak, whichever is larger (a
    copy of `chip_smoke.py::_bound`). M = rays x samples x levels x 8."""
    s = step_shapes(cfg)
    M, C = s["rays"] * s["samples"] * s["levels"] * 8, s["channels"]
    return max(scatter_bytes(cfg) / HBM_BYTES_S, M * C / PEAK_F32_FLOPS)


def scatter_bytes(cfg: dict) -> int:
    """The bytes of `scatter_bound_s`: values, row ids and output."""
    s = step_shapes(cfg)
    M, C = s["rays"] * s["samples"] * s["levels"] * 8, s["channels"]
    return M * C * (2 if s["amp"] else 4) + M * 4 + s["rows"] * C * 4


def step_peak_flops(cfg: dict) -> float:
    """The peak the step's precision allows: bf16 under amp, else
    float32."""
    return PEAK_BF16_FLOPS if cfg.get("amp", True) else PEAK_F32_FLOPS
