"""Scatter inputs shared by the CPU and the card tests of the port's
`scatter_rows` (numpy only)."""
import numpy as np


def runs_case(n_samples, group, D, C, seed, shuffle=False, negative=True):
    """(vals (M, C) f32, rows (M,) int32) laid out as the hash-grid encoder
    lays them out: @group columns whose rows repeat along the sample axis
    in runs of 1-199 samples (longer than a warp and than the kernel's
    RUN_SAMPLES), sentinels D (and, with @negative, ids -1 and D + 7)
    inside the runs, and M = n_samples * group - 5, so no tile is whole.
    @shuffle permutes the entries: the same sums, no layout."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(group):
        ids = rng.integers(0, D, n_samples)
        cols.append(np.repeat(ids, rng.integers(1, 200, n_samples))[:n_samples])
    rows = np.stack(cols, 1).reshape(-1)[:n_samples * group - 5]
    rows = rows.astype(np.int32)
    rows[rng.random(rows.size) < 0.05] = D
    if negative:
        rows[rng.random(rows.size) < 0.01] = -1
        rows[rng.random(rows.size) < 0.01] = D + 7
    vals = rng.standard_normal((rows.size, C)).astype(np.float32)
    if shuffle:
        perm = rng.permutation(rows.size)
        rows, vals = rows[perm], vals[perm]
    return vals, rows
