"""What the NOF step's CUDA graph (`nof/train.py::StepGraph`) rests on,
held on the CPU: the step's two former host constants now made on the
device give bit-equal results (`se3_exp`'s bottom row, `hashgrid_corners`'
layout constants), `capture_key` changes exactly when a tensor the step
reads is rebound, and a `StepGraph` driven with a stand-in graph that
records its calls captures once after one eager step and again after
each rebinding. The graph itself runs on the card only
(`tests/test_torch_cuda.py`)."""
import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch.nof.train import (StepGraph, capture_key,
                                           make_optimizer)
from bundlesdf_tpu_torch.ops.hashgrid import (_CORNERS, _PRIMES, HashGridSpec,
                                              hashgrid_corners)
from bundlesdf_tpu_torch.utils import profiling
from bundlesdf_tpu_torch.utils.se3 import (_so3_left_jacobian, se3_exp,
                                           so3_exp)
from nof_tiny import tiny_runner


def _se3_exp_uploaded_row(tau):
    """`se3_exp` with its bottom row uploaded from the host (the formula
    before the row was made on the device)."""
    t, w = tau[..., :3], tau[..., 3:6]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    trans = (V @ t[..., None])[..., 0]
    top = torch.cat([R, trans[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tau.dtype,
                          device=tau.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


@pytest.mark.parametrize("shape", [(6,), (17, 6), (3, 5, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se3_exp_row_made_on_device_is_bit_equal(shape, dtype):
    g = torch.Generator().manual_seed(len(shape))
    tau = torch.randn(shape, generator=g, dtype=dtype)
    tau.view(-1, 6)[0] = 0.0                     # the Taylor-safe origin
    tau.requires_grad_()
    got, want = se3_exp(tau), _se3_exp_uploaded_row(tau)
    assert got.shape == shape[:-1] + (4, 4)
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=g, dtype=dtype)
    ga, = torch.autograd.grad(got, tau, cot)
    gb, = torch.autograd.grad(want, tau, cot)
    assert torch.equal(ga, gb)


def _corners_uploaded_constants(x, spec):
    """`hashgrid_corners` with its layout constants uploaded on each call
    (the formula before they were made once per spec and device)."""
    layout = spec.layout()
    all_dense = all(dense for _, dense, _, _ in layout)
    res_i = torch.tensor([r for r, _, _, _ in layout], dtype=torch.int64)
    corners = torch.as_tensor(_CORNERS)
    dense = None if all_dense else torch.tensor(
        [d for _, d, _, _ in layout])
    offs = torch.tensor([o for _, _, _, o in layout], dtype=torch.int64)
    x01 = torch.clamp((x.float() + 1.0) * 0.5, 0.0, 1.0)
    xl = x01[:, None, :] * res_i.float()[None, :, None]
    x0 = torch.minimum(torch.floor(xl).long().clamp(min=0),
                       (res_i - 1)[None, :, None])
    w = xl - x0.float()
    cb = corners.bool()[None, None]
    f = torch.where(cb, w[:, :, None, :], 1.0 - w[:, :, None, :])
    wc = f[..., 0] * f[..., 1] * f[..., 2]
    c = x0[:, :, None, :] + corners.long()[None, None]
    S = (res_i + 1)[None, :, None]
    rows = (c[..., 0] * S + c[..., 1]) * S + c[..., 2]
    if not all_dense:
        h = ((c[..., 0] * _PRIMES[0]) ^ (c[..., 1] * _PRIMES[1])
             ^ (c[..., 2] * _PRIMES[2])) & 0xFFFFFFFF
        rows = torch.where(dense[None, :, None], rows,
                           h & (spec.table_size - 1))
    return (rows + offs[None, :, None]).to(torch.int32), wc


@pytest.mark.parametrize("spec", [
    HashGridSpec(n_levels=2, base_res=8, finest_res=16,
                 log2_hashmap_size=12),                     # all dense
    HashGridSpec(n_levels=6, base_res=16, finest_res=512,
                 log2_hashmap_size=14)])                    # hashed levels
def test_hashgrid_corners_bit_equal_to_uploaded_constants(spec):
    g = torch.Generator().manual_seed(spec.n_levels)
    x = (torch.rand((4096, 3), generator=g) * 2.4 - 1.2).requires_grad_()
    rows, wc = hashgrid_corners(x, spec)
    rows_u, wc_u = _corners_uploaded_constants(x, spec)
    assert rows.dtype == torch.int32 and torch.equal(rows, rows_u)
    assert torch.equal(wc, wc_u)
    cot = torch.randn(wc.shape, generator=g)
    ga, = torch.autograd.grad(wc, x, cot)
    gb, = torch.autograd.grad(wc_u, x, cot)
    assert torch.equal(ga, gb)
    # the constants are made once per (spec, device)
    again, _ = hashgrid_corners(x.detach(), spec)
    assert torch.equal(again, rows)


def _key(r):
    return capture_key(r.field, r.rays, r.n_rays_valid, r.c2w, r.occ_grid,
                       r.rcfg, r.lcfg, r.tcfg, r.generator)


def test_capture_key_changes_exactly_when_a_tensor_is_rebound():
    r = tiny_runner()
    k0 = _key(r)
    assert _key(r) == k0
    r.train(n_steps=1)                 # the gradients now exist
    k1 = _key(r)
    assert k1 != k0
    with torch.no_grad():              # in place: the same tensors
        r.field.pose_array.add_(1e-3)
        r.c2w.mul_(1.0)
        r.rays["rgb"].add_(0.0)
    assert _key(r) == k1
    r.optimizer = make_optimizer(r.field, r.tcfg)   # Adam is not captured
    assert _key(r) == k1
    c2w = r.c2w
    r.c2w = c2w.clone()
    assert _key(r) != k1
    r.c2w = c2w
    assert _key(r) == k1
    grad = r.field.table.grad
    r.field.table.grad = grad.clone()  # an eager step's new gradient
    assert _key(r) != k1
    r.field.table.grad = grad
    assert _key(r) == k1
    r.occ_grid = r._build_occupancy()
    k2 = _key(r)
    assert k2 != k1
    r.rays = dict(r.rays, depth=r.rays["depth"].clone())
    assert _key(r) != k2
    r._upload_rays()
    k3 = _key(r)
    assert capture_key(r.field, r.rays, r.n_rays_valid - 1, r.c2w,
                       r.occ_grid, r.rcfg, r.lcfg, r.tcfg,
                       r.generator) != k3
    r.add_new_frames(r.images[:1], r.depths[:1], r.masks[:1], None,
                     list(r.poses) + [r.poses[0]])
    assert _key(r) != k3


class RecordingGraph:
    """A stand-in for `torch.cuda.CUDAGraph` that records its calls; what
    it "captures" runs at once, and a replay does nothing."""

    made = []

    def __init__(self):
        self.calls = []
        RecordingGraph.made.append(self)

    def register_generator_state(self, generator):
        self.calls.append(("register", generator))

    def capture_begin(self, capture_error_mode="global"):
        self.calls.append(("begin", capture_error_mode))

    def capture_end(self):
        self.calls.append(("end",))

    def replay(self):
        self.calls.append(("replay",))


def _run(graph, r, n):
    m = graph.run(r.field, r.optimizer, r.rays, r.n_rays_valid, r.c2w,
                  r.occ_grid, r.global_step, n, r.rcfg, r.lcfg, r.tcfg,
                  r.N_iters, r.generator)
    r.global_step += n
    return m


def _counts(before, *names):
    after = profiling.snapshot()
    return [after.get(n, (0, 0.0))[0] - before.get(n, (0, 0.0))[0]
            for n in names]


def test_step_graph_captures_after_one_eager_step_and_on_each_rebinding():
    RecordingGraph.made.clear()
    r = tiny_runner()
    graph = StepGraph(new_graph=RecordingGraph)
    before = profiling.snapshot()
    m = _run(graph, r, 5)
    assert {k: v.shape for k, v in m.items()} == {
        k: (5,) for k in ("fs_loss", "loss", "rgb_loss", "sdf_loss")}
    made = RecordingGraph.made
    assert len(made) == 1
    assert made[0].calls == [("register", r.generator),
                             ("begin", "thread_local"), ("end",)] \
        + [("replay",)] * 4
    assert _counts(before, "nof.graph.capture", "nof.graph.replay",
                   "nof.step") == [1, 4, 5]
    # more steps than the metrics buffer holds replay on the same graph
    assert _run(graph, r, StepGraph.CAPACITY + 3)["loss"].shape == (
        StepGraph.CAPACITY + 3,)
    assert len(made) == 1
    # a keyframe batch: 1 + 2 + 7 steps, the last nine replays
    r.add_new_frames(r.images[:1], r.depths[:1], r.masks[:1], None,
                     list(r.poses) + [r.poses[0]])
    before = profiling.snapshot()
    for n in (1, 2, 7):
        _run(graph, r, n)
    assert len(made) == 2
    assert _counts(before, "nof.graph.capture", "nof.graph.replay",
                   "nof.step") == [1, 9, 10]
    r.occ_grid = r._build_occupancy()
    _run(graph, r, 4)
    assert len(made) == 3
    assert _counts(before, "nof.graph.capture", "nof.graph.replay",
                   "nof.step") == [2, 12, 14]
