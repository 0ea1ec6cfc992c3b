"""`ops/adam.py::Adam`, the NOF's optimizer, on the CPU: there its step is
`torch.optim.Adam.step` itself (the kernel's plain twin), and the state it
keeps is torch's, so checkpoints, `state_dict` and DP's replica sync carry
it unchanged. The checks that keep other inputs from the kernel raise on
any device. The kernel against torch's foreach Adam is in
`test_torch_cuda.py` (it needs a card)."""
import numpy as np
import pytest
import torch

from bundlesdf_tpu_torch.nof.train import (TrainConfig, lr_factor_at,
                                           make_optimizer)
from bundlesdf_tpu_torch.ops import adam as A
from bundlesdf_tpu_torch.utils import profiling

BETAS, EPS = (0.9, 0.999), 1e-15


def _launches():
    return profiling.snapshot().get("adam.launches", (0, 0.0))[0]


def _params(seed=0):
    """A table-like tensor, two MLP-like ones and a pose array."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(4099, 2), (32, 64), (64,), (5, 6)]
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in shapes]


def _groups(params, lr=0.01, lr_pose=0.003):
    return [{"params": params[:-1], "lr": lr, "base_lr": lr},
            {"params": params[-1:], "lr": lr_pose, "base_lr": lr_pose}]


def _grads(params, step):
    g = torch.Generator().manual_seed(1000 + step)
    for p in params:
        # sparse like the table's gradient, magnitudes over decades
        scale = torch.exp(torch.randn(p.shape, generator=g) * 3)
        keep = torch.rand(p.shape, generator=g) < 0.4
        p.grad = torch.randn(p.shape, generator=g) * scale * keep


def _train(opt, params, steps, start=0, n_iters=30):
    tcfg = TrainConfig(decay_rate=0.1)
    for i in range(start, start + steps):
        _grads(params, i)
        f = lr_factor_at(i, tcfg, n_iters)
        for group in opt.param_groups:
            group["lr"] = group["base_lr"] * f
        opt.step()


def _assert_same(a_params, a_opt, b_params, b_opt):
    for p, q in zip(a_params, b_params):
        assert torch.equal(p, q)
        sa, sb = a_opt.state[p], b_opt.state[q]
        assert list(sa) == list(sb) == ["step", "exp_avg", "exp_avg_sq"]
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and sa[k].device == sb[k].device
            assert torch.equal(sa[k], sb[k]), k


def test_cpu_step_is_torch_adam():
    """30 steps with two groups under the staircase lr: the parameters,
    moments and step counts equal torch.optim.Adam's bit for bit, and no
    kernel launches."""
    mine, ref = _params(), _params()
    opt = A.Adam(_groups(mine), betas=BETAS, eps=EPS)
    ref_opt = torch.optim.Adam(_groups(ref), betas=BETAS, eps=EPS)
    assert isinstance(opt, torch.optim.Adam)
    n0 = _launches()
    _train(opt, mine, 30)
    _train(ref_opt, ref, 30)
    _assert_same(mine, opt, ref, ref_opt)
    assert opt.state[mine[0]]["step"].dtype == torch.float32
    assert float(opt.state[mine[0]]["step"]) == 30.0
    assert _launches() == n0


def test_make_optimizer_gives_the_kernel_adam():
    from nof_tiny import tiny_runner
    r = tiny_runner()
    opt = make_optimizer(r.field, r.tcfg)
    assert type(opt) is A.Adam
    rest, pose = opt.param_groups
    assert pose["params"] == [r.field.pose_array]
    assert len(rest["params"]) == len(list(r.field.parameters())) - 1
    assert (rest["lr"], rest["base_lr"]) == (r.tcfg.lrate, r.tcfg.lrate)
    assert all(g["betas"] == BETAS and g["eps"] == EPS
               for g in opt.param_groups)


def test_state_dict_round_trip():
    """Five steps, the state dict into a new optimizer over copies of the
    parameters, five more steps: the same as ten steps of one optimizer."""
    a, b = _params(), _params()
    opt_a = A.Adam(_groups(a), betas=BETAS, eps=EPS)
    opt_b = A.Adam(_groups(b), betas=BETAS, eps=EPS)
    _train(opt_a, a, 5)
    _train(opt_b, b, 5)
    c = [torch.nn.Parameter(p.detach().clone()) for p in b]
    opt_c = A.Adam(_groups(c), betas=BETAS, eps=EPS)
    opt_c.load_state_dict(opt_b.state_dict())
    _assert_same(b, opt_b, c, opt_c)
    _train(opt_a, a, 5, start=5)
    _train(opt_c, c, 5, start=5)
    _assert_same(a, opt_a, c, opt_c)


def test_save_and_load_weights_keep_the_adam_state(tmp_path):
    """`NofRunner.save_weights` / `load_weights` carry the moments and step
    counts of the kernel Adam as they did torch's."""
    from nof_tiny import tiny_runner
    r = tiny_runner()
    r.train(n_steps=3)
    path = str(tmp_path / "w.npz")
    r.save_weights(path)
    r2 = tiny_runner(seed=1)
    r2.load_weights(path)
    assert type(r2.optimizer) is A.Adam
    _assert_same(list(r.field.parameters()), r.optimizer,
                 list(r2.field.parameters()), r2.optimizer)
    m1, m2 = r.train(n_steps=2), r2.train(n_steps=2)
    assert np.isfinite(m2["loss"]).all() and m1["loss"].shape == (2,)


def test_dp_sync_replicas_copies_the_adam_state():
    """DP's replicas get the kernel Adam and, at `sync_replicas`, the
    master's moments and step counts."""
    from nof_tiny import tiny_runner
    from bundlesdf_tpu_torch.parallel import dp
    r = tiny_runner()
    r.train(n_steps=2)
    reps = dp.make_replicas(r.field, [torch.device("cpu")] * 2,
                            optimizer=r.optimizer, tcfg=r.tcfg)
    assert type(reps[1].optimizer) is A.Adam
    _assert_same(list(r.field.parameters()), r.optimizer,
                 list(reps[1].field.parameters()), reps[1].optimizer)


def test_parameters_without_gradient_are_skipped():
    """A parameter whose `.grad` is None gets no state and keeps its value,
    as in torch's Adam; the others step."""
    p, q = _params()[:2]
    opt = A.Adam([p, q], lr=0.1, betas=BETAS, eps=EPS)
    q0 = q.detach().clone()
    p.grad = torch.ones_like(p)
    opt.step()
    assert q not in opt.state and torch.equal(q, q0)
    assert float(opt.state[p]["step"]) == 1.0


@pytest.mark.parametrize("option,value", [
    ("amsgrad", True), ("weight_decay", 0.01), ("maximize", True),
    ("foreach", False), ("capturable", True), ("fused", True)])
def test_options_the_kernel_does_not_compute_raise(option, value):
    p = _params()[0]
    opt = A.Adam([p], lr=0.1, betas=BETAS, eps=EPS)
    opt.param_groups[0][option] = value
    p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match=option):
        opt.step()


def test_tensor_lr_raises():
    p = _params()[0]
    opt = A.Adam([p], lr=0.1, betas=BETAS, eps=EPS)
    opt.param_groups[0]["lr"] = torch.tensor(0.1)
    p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match="Python numbers"):
        opt.step()


def test_parameters_on_two_devices_raise():
    p = torch.nn.Parameter(torch.ones(4))
    q = torch.nn.Parameter(torch.ones(4, device="meta"))
    p.grad, q.grad = torch.ones(4), torch.ones(4, device="meta")
    opt = A.Adam([p, q], lr=0.1)
    with pytest.raises(ValueError, match="one CUDA device"):
        opt.step()


def _quad(**over):
    t = {k: torch.zeros(8, 4) for k in ("p", "g", "m", "v")}
    t.update(over)
    return [t["p"]], [t["g"]], [t["m"]], [t["v"]]


@pytest.mark.parametrize("over,error,match", [
    ({"g": torch.zeros(8, 4, dtype=torch.float64)}, TypeError, "float32"),
    ({"m": torch.zeros(4, 8).t()}, ValueError, "contiguous"),
    ({"v": torch.zeros(8, 4).to_sparse()}, ValueError, "contiguous"),
    ({"v": torch.zeros(32)}, ValueError, "shapes"),
    ({"g": torch.zeros(8, 4, device="meta")}, ValueError, "one CUDA device"),
    ({}, ValueError, "CUDA tensors")])
def test_check_tensors_keeps_other_inputs_from_the_kernel(over, error, match):
    """What the kernel does not take raises before any launch: another
    dtype, layout or shape, two devices, or tensors off the card."""
    with pytest.raises(error, match=match):
        A.check_tensors(*_quad(**over))
