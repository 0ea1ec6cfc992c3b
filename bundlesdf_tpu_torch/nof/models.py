"""NOF model family: hash-grid + tiny SDF/color MLP + per-frame corrections.

Port of `bundlesdf_tpu/nof/models.py`, itself a re-design of the reference
torch modules (`nerf_helpers.py`):
  - `NeRFSmall` (nerf_helpers.py:243-321): 2-layer sigma net -> 1 SDF + 15
    geo features; 3-layer color net; SDF head bias init 0.1 (:272).
  - `SHEncoder` (nerf_helpers.py:22-105): real spherical harmonics of the
    view direction, degree<=5.
  - `Embedder` (nerf_helpers.py:156-189): NeRF frequency encoding (i_embed=0).
  - `FeatureArray` (nerf_helpers.py:108-124): per-frame latent, N(0,1) init.
  - `PoseArray` (nerf_helpers.py:127-154): per-frame SE(3) correction,
    tanh-bounded, frame 0 pinned to identity.

`NofField` holds every parameter; `forward` and `sdf` have the semantics
of the JAX `nof_forward` / `nof_sdf`, including the explicit compute-dtype
casts under AMP. `params_from_jax` loads a JAX parameter pytree;
`params_to_jax` gives one back.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bundlesdf_tpu_torch.ops.hashgrid import (HashGridSpec, hashgrid_encode,
                                              init_hashgrid_params)
from bundlesdf_tpu_torch.utils.profiling import span
from bundlesdf_tpu_torch.utils.se3 import se3_exp

# ---------------------------------------------------------------------------
# Spherical-harmonics view encoding (ref nerf_helpers.py:22-105)
# ---------------------------------------------------------------------------

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_encode(dirs, degree: int):
    """Real SH basis of unit directions. (...,3) -> (..., degree**2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        out += [_C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
                _C3[2] * y * (4 * zz - xx - yy),
                _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3 * yy)]
    if degree > 4:
        out += [_C4[0] * xy * (xx - yy), _C4[1] * yz * (3 * xx - yy),
                _C4[2] * xy * (7 * zz - 1), _C4[3] * yz * (7 * zz - 3),
                _C4[4] * (zz * (35 * zz - 30) + 3), _C4[5] * xz * (7 * zz - 3),
                _C4[6] * (xx - yy) * (7 * zz - 1), _C4[7] * xz * (xx - 3 * yy),
                _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)


def freq_encode(x, n_freqs: int):
    """NeRF frequency encoding with include_input (ref nerf_helpers.py:156-189).
    (...,3) -> (...,3 + 3*2*n_freqs)."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xs = x[..., None, :] * freqs[:, None]  # (...,F,3)
    enc = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


# ---------------------------------------------------------------------------
# Spec + module
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NofSpec:
    """Static model configuration (as the JAX NofSpec)."""
    grid: HashGridSpec = field(default_factory=HashGridSpec)
    sh_degree: int = 3              # multires_views (ref config.yml:24)
    frame_features: int = 0         # per-frame latent dim (config.yml:70)
    n_frames: int = 1
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_sigma: int = 2       # ref nerf_runner.py:222
    num_layers_color: int = 3
    max_trans: float = 0.02         # already scaled by sc_factor at build time
    max_rot_deg: float = 20.0
    use_viewdirs: bool = True
    # embedder selection (ref get_embedder nerf_helpers.py:191-214):
    # positions: 1 = hash grid, 0 = NeRF frequency encoding, -1 = identity.
    # views: 2 = SH (degree sh_degree), 0 = freq (sh_degree freqs), -1 = id.
    i_embed: int = 1
    i_embed_views: int = 2
    multires: int = 8               # freq count for i_embed=0 (config.yml)

    @property
    def pos_dim(self) -> int:
        if self.i_embed == 1:
            return self.grid.out_dim
        if self.i_embed == 0:
            return 3 + 3 * 2 * self.multires
        return 3  # identity

    @property
    def view_dim(self) -> int:
        if not self.use_viewdirs:
            d = 0
        elif self.i_embed_views == 2:
            d = self.sh_degree ** 2
        elif self.i_embed_views == 0:
            d = 3 + 3 * 2 * self.sh_degree
        else:
            d = 3
        return d + self.frame_features


def _linear(n_in, n_out, generator, device, bias_const=None):
    """torch.nn.Linear's default init (kaiming-uniform a=sqrt(5)): weight
    and bias ~ U(-1/sqrt(n_in), 1/sqrt(n_in)), drawn from @generator."""
    layer = nn.Linear(n_in, n_out, device=device)
    bound = 1.0 / np.sqrt(n_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias_const is None:
            layer.bias.uniform_(-bound, bound, generator=generator)
        else:
            layer.bias.fill_(bias_const)
    return layer


def _mlp(layers, x, dtype):
    for i, layer in enumerate(layers):
        x = F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))
        if i != len(layers) - 1:
            x = F.relu(x)
    return x


class NofField(nn.Module):
    """The Neural Object Field: hash grid (`table`), `sigma_net`,
    `color_net`, per-frame `pose_array` and optional `feature_array`."""

    def __init__(self, spec: NofSpec, generator=None, device=None):
        super().__init__()
        self.spec = spec
        sigma_dims = ([spec.pos_dim] + [spec.hidden_dim] * (spec.num_layers_sigma - 1)
                      + [1 + spec.geo_feat_dim])
        color_dims = ([spec.view_dim + spec.geo_feat_dim]
                      + [spec.hidden_dim] * (spec.num_layers_color - 1) + [3])
        # SDF-head bias 0.1 encourages initially-positive SDF (ref :272)
        self.sigma_net = nn.ModuleList(
            _linear(sigma_dims[i], sigma_dims[i + 1], generator, device,
                    bias_const=0.1 if i == spec.num_layers_sigma - 1 else None)
            for i in range(spec.num_layers_sigma))
        self.color_net = nn.ModuleList(
            _linear(color_dims[i], color_dims[i + 1], generator, device)
            for i in range(spec.num_layers_color))
        self.pose_array = nn.Parameter(
            torch.zeros((spec.n_frames, 6), device=device))
        if spec.i_embed == 1:
            self.table = nn.Parameter(init_hashgrid_params(
                spec.grid, generator=generator, device=device))
        if spec.frame_features > 0:
            self.feature_array = nn.Parameter(torch.randn(
                (spec.n_frames, spec.frame_features), generator=generator,
                device=device))

    def _embed_pos(self, pts):
        """Position embedding per spec.i_embed (ref get_embedder i=1/0/-1)."""
        if self.spec.i_embed == 1:
            return hashgrid_encode(self.table, pts, self.spec.grid)
        if self.spec.i_embed == 0:
            return freq_encode(pts, self.spec.multires)
        return pts

    def _embed_views(self, viewdirs):
        """View embedding per spec.i_embed_views (ref get_embedder i=2/0/-1)."""
        if self.spec.i_embed_views == 2:
            return sh_encode(viewdirs, self.spec.sh_degree)
        if self.spec.i_embed_views == 0:
            return freq_encode(viewdirs, self.spec.sh_degree)
        return viewdirs

    def forward(self, pts, viewdirs=None, frame_ids=None,
                compute_dtype=torch.float32):
        """Full field query. @pts: (N,3) in [-1,1] (normalized object
        space); @viewdirs: (N,3) unit dirs; @frame_ids: (N,) int.
        Returns (N,4) float32: rgb logits (3) + sdf (1) (ref NeRFSmall.forward
        + run_network embedding assembly nerf_runner.py:1227-1304)."""
        feats = self._embed_pos(pts).to(compute_dtype)
        h = _mlp(self.sigma_net, feats, compute_dtype)
        sdf, geo = h[..., :1], h[..., 1:]

        views = []
        if self.spec.frame_features > 0 and frame_ids is not None:
            views.append(self.feature_array[frame_ids].to(compute_dtype))
        if self.spec.use_viewdirs and viewdirs is not None:
            views.append(self._embed_views(viewdirs).to(compute_dtype))
        color_in = torch.cat(views + [geo], dim=-1)
        rgb = _mlp(self.color_net, color_in, compute_dtype)
        return torch.cat([rgb, sdf], dim=-1).float()

    def sdf(self, pts, compute_dtype=torch.float32):
        """SDF-only query (mesh extraction / eikonal; ref
        run_network_density nerf_runner.py:1307-1347)."""
        feats = self._embed_pos(pts).to(compute_dtype)
        return _mlp(self.sigma_net, feats, compute_dtype)[..., 0].float()


def pose_array_matrices(pose_params, frame_ids, max_trans, max_rot_deg):
    """Per-frame SE(3) corrections (ref PoseArray.get_matrices
    nerf_helpers.py:142-154): tanh-bounded translation/axis-angle, exp-map,
    frame 0 pinned to identity (out of place, so autograd sees it)."""
    theta = torch.tanh(pose_params)
    trans = theta[:, :3] * max_trans
    rot = theta[:, 3:6] * (max_rot_deg / 180.0 * np.pi)
    with span("pull.nof.pose"):  # se3_exp uploads a constant: a wait
        Ts = se3_exp(torch.cat([trans, rot], dim=-1))  # (F,4,4)
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    Ts = torch.cat([eye[None], Ts[1:]], dim=0)
    return Ts[frame_ids]


def params_from_jax(np_params: dict) -> dict:
    """State dict for `NofField` from the JAX parameter pytree given as
    numpy arrays (`bundlesdf_tpu.nof.models.init_nof_params`). A JAX layer
    `w` is (n_in, n_out); `nn.Linear.weight` is its transpose."""
    sd = {}
    for net in ("sigma_net", "color_net"):
        for i, layer in enumerate(np_params[net]):
            sd[f"{net}.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(layer["w"], np.float32).T))
            sd[f"{net}.{i}.bias"] = torch.from_numpy(
                np.asarray(layer["b"], np.float32).copy())
    for k in ("pose_array", "table", "feature_array"):
        if k in np_params:
            sd[k] = torch.from_numpy(np.asarray(np_params[k], np.float32).copy())
    return sd


def params_to_jax(state: dict) -> dict:
    """Inverse of `params_from_jax`: the JAX parameter pytree, as numpy
    arrays, from a `NofField` state dict (or any dict keyed like one, such
    as its Adam moments)."""
    out = {}
    for net in ("sigma_net", "color_net"):
        n = len({k.split(".")[1] for k in state if k.startswith(net + ".")})
        out[net] = [{"w": state[f"{net}.{i}.weight"].detach().cpu().numpy().T,
                     "b": state[f"{net}.{i}.bias"].detach().cpu().numpy()}
                    for i in range(n)]
    for k in ("pose_array", "table", "feature_array"):
        if k in state:
            out[k] = state[k].detach().cpu().numpy()
    return out
