"""The hash-grid backward's row scatter-add, plain: `index_add_` over the
in-range rows, accumulated in float32 (the contract of the port's
`ops/scatter.py::scatter_rows`, without its CUDA kernel)."""
from __future__ import annotations

import torch


def scatter_rows(vals, rows, n_rows: int, group: int = 1):
    """(n_rows, C) float32: out[r] = the sum of vals[m] over rows[m] == r;
    rows outside [0, n_rows) drop out. @group changes no result."""
    keep = (rows >= 0) & (rows < n_rows)
    out = torch.zeros((n_rows, vals.shape[-1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, rows[keep].long(), vals[keep].float())
