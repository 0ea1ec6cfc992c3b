"""Ray sample placement.

Port of `bundlesdf_tpu/ops/sampling.py`, which replaces the reference's
stratified samplers: `sample_rays_uniform` (nerf_runner.py:68-87), the
occupied-voxel segment sampler CUDA kernel (`mycuda/common.cu:41-125`)
and hierarchical `sample_pdf` (nerf_helpers.py:324-354). The JAX package's
comparison-sum searchsorted and one-hot lookups are TPU workarounds; here
the lookups are `torch.searchsorted(..., right=True)` and `torch.gather`.
The z arithmetic stays differentiable, so the pose gradient through the
segment tables (`t0`, `cum0`) survives, as in the JAX package.

Random draws come from an explicit `torch.Generator`.
"""
from __future__ import annotations

import torch


def linspace01(n: int, device=None):
    """(n,) float32 in [0, 1] with the JAX package's rounding
    (`jnp.linspace` multiplies the iota by the reciprocal of n-1 and pins
    the endpoint), so deterministic samples agree bit for bit."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * (1.0 / (n - 1))
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def sample_rays_uniform(near, far, n_samples: int, perturb: bool = True,
                        generator=None):
    """Stratified uniform z samples in [near, far] per ray.
    @near, @far: (N,1). Returns (N, n_samples)."""
    N = near.shape[0]
    t = linspace01(n_samples, near.device)[None, :]
    z = near * (1.0 - t) + far * t
    if perturb:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        u = torch.rand((N, n_samples), generator=generator,
                       device=near.device)
        z = lower + (upper - lower) * u
        z = torch.minimum(torch.maximum(z, near), far)
    return z


def occupied_sampler_state(t0, t1, occ, t_cap=None):
    """Per-ray segment tables shared by every draw from the same trace:
    clipped step starts, cumulative occupied length, total.

    @t0,t1: (N,S) step bounds; @occ: (N,S) bool; @t_cap: optional (N,)
    upper clamp (depth + trunc, ref nerf_runner.py:992-999).
    """
    N = occ.shape[0]
    if t_cap is not None:
        # clip segments beyond the cap (reference clamps z_in_out to depth+trunc)
        t0 = torch.minimum(t0, t_cap[:, None])
        t1 = torch.minimum(t1, t_cap[:, None])
    seg_len = torch.where(occ, t1 - t0, torch.zeros_like(t0))
    cum = torch.cumsum(seg_len, dim=-1)  # (N,S)
    cum0 = torch.cat([torch.zeros((N, 1), dtype=cum.dtype, device=cum.device),
                      cum[:, :-1]], dim=-1)
    total = cum[:, -1:]
    return {"t0": t0, "t1": t1, "cum": cum, "cum0": cum0, "total": total,
            "no_hit": total[:, 0] <= 1e-12}


def _stratified_u01(N, n_samples: int, perturb: bool, generator, device):
    t = linspace01(n_samples, device)[None, :]
    if not perturb:
        return t.expand(N, n_samples)
    mids_hi = torch.clamp(t + 0.5 / max(n_samples - 1, 1), max=1.0)
    mids_lo = torch.clamp(t - 0.5 / max(n_samples - 1, 1), min=0.0)
    u = torch.rand((N, n_samples), generator=generator, device=device)
    return mids_lo + (mids_hi - mids_lo) * u


def draw_occupied_samples(state, n_samples: int, perturb: bool = True,
                          generator=None):
    """Stratified samples over the concatenated occupied length of each
    ray, mapped back into their segments (ref `sampleRaysUniformOccupied
    Voxels`, mycuda/common.cu:41). Rays with no occupied step fall back to
    uniform samples over the whole step range. Returns (N, n_samples)."""
    t0, cum, cum0 = state["t0"], state["cum"], state["cum0"]
    N, S = t0.shape
    u01 = _stratified_u01(N, n_samples, perturb, generator, t0.device)
    u = u01 * state["total"]
    # segment of each sample: count of cum <= u, the last slot absorbing S
    idx = torch.searchsorted(cum.detach().contiguous(), u.detach().contiguous(),
                             right=True).clamp(max=S - 1)
    z = torch.gather(t0, 1, idx) + (u - torch.gather(cum0, 1, idx))

    # fallback: uniform over the whole step range when nothing occupied
    z_uniform = t0[:, :1] + u01 * (state["t1"][:, -1:] - t0[:, :1])
    return torch.where(state["no_hit"][:, None], z_uniform, z)


def sample_occupied_steps(t0, t1, occ, n_samples: int, perturb: bool = True,
                          generator=None, t_cap=None):
    """Stratified samples distributed over the union of occupied ray steps
    (ref `sampleRaysUniformOccupiedVoxels`, mycuda/common.cu:41): the
    segment tables of `occupied_sampler_state`, then one
    `draw_occupied_samples`. @t0,t1: (N,S) step bounds from
    `ray_trace_occupancy`; @occ: (N,S) bool; @t_cap: optional (N,) upper
    clamp. Rays with no occupied step fall back to the full step range.
    Returns (N, n_samples) t values."""
    state = occupied_sampler_state(t0, t1, occ, t_cap=t_cap)
    return draw_occupied_samples(state, n_samples, perturb=perturb,
                                 generator=generator)


def sample_pdf(bins, weights, n_samples: int, det: bool = False,
               generator=None):
    """Hierarchical importance sampling by inverse-CDF
    (ref nerf_helpers.py:324-354). @bins: (N,B), @weights: (N,B-1)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N,B)
    N = cdf.shape[0]
    if det:
        u = linspace01(n_samples, cdf.device)[None, :].expand(N, n_samples)
    else:
        u = torch.rand((N, n_samples), generator=generator,
                       device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins, 1, below)
    bins_a = torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
