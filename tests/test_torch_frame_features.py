"""The field's frame-feature gather on the per-ray path (`NofField` given
one frame id a ray and `samples_per_ray`, as `render_rays` calls it)
against the per-sample gather (one id a sample, `repeat_interleave`d from
the rays' ids), held on the CPU: the forward bit-equal at float32 and
bfloat16 compute, every gradient but `feature_array`'s bit-equal, and
`feature_array`'s within float32 summation-order error, with frames hit
unevenly. One case builds bfloat16 cotangents whose per-ray sums bfloat16
cannot hold, so casting before the broadcast would miss that tolerance.
The counter `nof.feature_rows` counts the rows the gather reads: one a
ray a query, none without frame features, and through `StepGraph` one
step's rows for each replay."""
import pytest
import torch

from bundlesdf_tpu_torch.nof.models import NofField, NofSpec
from bundlesdf_tpu_torch.nof.train import StepGraph
from bundlesdf_tpu_torch.ops.hashgrid import HashGridSpec
from bundlesdf_tpu_torch.utils import profiling
from nof_tiny import tiny_runner

N_FRAMES, N_RAYS, S = 6, 48, 12
# |per-ray - per-sample| <= RTOL * sum |per-sample cotangents| of a frame row
RTOL = 1e-6


def _field(frame_features=2, seed=0):
    spec = NofSpec(grid=HashGridSpec(n_levels=2, base_res=4, finest_res=8,
                                     log2_hashmap_size=8),
                   frame_features=frame_features, n_frames=N_FRAMES)
    return NofField(spec, generator=torch.Generator().manual_seed(seed))


def _uneven_ids(g):
    """Per-ray frame ids: frame 2 for most rays, 0, 1 and 3 for a few,
    frames 4 and 5 never."""
    ids = torch.full((N_RAYS,), 2, dtype=torch.int64)
    few = torch.randperm(N_RAYS, generator=g)[:9]
    ids[few] = torch.tensor([0, 1, 3] * 3)
    return ids


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((N_RAYS * S, 3), generator=g) * 2 - 1
    dirs = torch.nn.functional.normalize(
        torch.randn((N_RAYS * S, 3), generator=g), dim=-1)
    cot = torch.randn((N_RAYS * S, 4), generator=g)
    return pts, dirs, _uneven_ids(g), cot


def _per_sample(field, pts, dirs, ids, dtype):
    """The query as `render_rays` made it before: one id a sample."""
    return field(pts, viewdirs=dirs,
                 frame_ids=torch.repeat_interleave(ids, S, dim=0),
                 compute_dtype=dtype)


def _per_ray(field, pts, dirs, ids, dtype):
    return field(pts, viewdirs=dirs, frame_ids=ids, samples_per_ray=S,
                 compute_dtype=dtype)


def _grads(field, out, cot):
    field.zero_grad(set_to_none=True)
    (out * cot).sum().backward()
    return {k: p.grad.clone() for k, p in field.named_parameters()
            if p.grad is not None}


def _abs_sums(ids, g):
    """Per frame row, the sum of |cotangent| over its samples (float64)."""
    rows = torch.repeat_interleave(ids, S, dim=0)
    return torch.zeros((N_FRAMES, g.shape[-1]), dtype=torch.float64) \
        .index_add_(0, rows, g.abs().double())


def _assert_within_summation_error(got, want, abs_sums):
    err = (got.double() - want.double()).abs()
    assert torch.all(err <= RTOL * abs_sums), (err, abs_sums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_per_ray_gather_matches_the_per_sample_gather(dtype, seed):
    field = _field(seed=seed)
    pts, dirs, ids, cot = _inputs(seed)
    seen = []
    gather = field._frame_features

    def spy(*args):
        out = gather(*args)
        out.retain_grad()
        seen.append(out)
        return out

    field._frame_features = spy
    want = _per_sample(field, pts, dirs, ids, dtype)
    want_g = _grads(field, want, cot)
    got = _per_ray(field, pts, dirs, ids, dtype)
    got_g = _grads(field, got, cot)
    assert torch.equal(got, want)
    for k in want_g:
        if k != "feature_array":
            assert torch.equal(got_g[k], want_g[k]), k
    # frames no ray hits get exactly nothing, on both paths
    for f in (4, 5):
        assert not want_g["feature_array"][f].any()
        assert not got_g["feature_array"][f].any()
    abs_sums = _abs_sums(ids, seen[0].grad.float())
    assert abs_sums[2].min() > 0
    _assert_within_summation_error(got_g["feature_array"],
                                   want_g["feature_array"], abs_sums)


def _cast_then_broadcast(field, ids, dtype):
    """The wrong order: each ray's latent cast first, so its backward
    rounds each ray's summed gradient to @dtype."""
    f = field.feature_array[ids].to(dtype)
    return f[:, None, :].expand(-1, S, -1).reshape(-1, f.shape[-1])


def test_broadcast_comes_before_the_bf16_cast():
    """bfloat16 cotangents 1 + k/128 (k in 1..3) are exact, and so is
    every float32 partial sum of them, so both float32 orders agree bit
    for bit; a ray's sum of 12 of them is 12 + m/128 (m in 12..36), which
    bfloat16, whose step is 1/16 there, holds only where 8 divides m."""
    field = _field()
    g = torch.Generator().manual_seed(7)
    ids = _uneven_ids(g)
    k = torch.randint(1, 4, (N_RAYS * S, 2), generator=g)
    cot = (1.0 + k / 128.0).to(torch.bfloat16)
    rows = torch.repeat_interleave(ids, S, dim=0)
    got = {}
    for name, feats in (
            ("per_sample", lambda: field._frame_features(rows, None,
                                                          torch.bfloat16)),
            ("per_ray", lambda: field._frame_features(ids, S,
                                                      torch.bfloat16)),
            ("cast_first", lambda: _cast_then_broadcast(field, ids,
                                                        torch.bfloat16))):
        field.zero_grad(set_to_none=True)
        f = feats()
        assert f.dtype == torch.bfloat16
        f.backward(cot)
        got[name] = field.feature_array.grad.clone()
    abs_sums = _abs_sums(ids, cot.float())
    assert torch.equal(got["per_ray"], got["per_sample"])
    _assert_within_summation_error(got["per_ray"], got["per_sample"],
                                   abs_sums)
    with pytest.raises(AssertionError):
        _assert_within_summation_error(got["cast_first"], got["per_sample"],
                                       abs_sums)


def _rows():
    return profiling.snapshot().get("nof.feature_rows", (0, 0.0))[0]


@pytest.mark.parametrize("frame_features", [0, 2])
def test_feature_rows_counts_one_row_a_ray_a_query(frame_features):
    field = _field(frame_features)
    pts, dirs, ids, _ = _inputs(3)
    n0 = _rows()
    _per_ray(field, pts, dirs, ids, torch.float32)
    assert _rows() - n0 == (N_RAYS if frame_features else 0)
    _per_sample(field, pts, dirs, ids, torch.float32)
    assert _rows() - n0 == (N_RAYS + N_RAYS * S if frame_features else 0)


class _StandInGraph:
    """A graph that records nothing and replays nothing."""

    def register_generator_state(self, generator):
        pass

    def capture_begin(self, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.mark.parametrize("frame_features", [0, 2])
def test_feature_rows_counts_each_step_eager_or_replayed(frame_features):
    """A tiny runner's steps through `StepGraph` (one eager step, a
    capture, four replays): the capture's rows are taken back and each
    replay adds one step's, `N_rand` rows a step with frame features."""
    r = tiny_runner(frame_features=frame_features)
    graph = StepGraph(new_graph=_StandInGraph)
    n0 = _rows()
    graph.run(r.field, r.optimizer, r.rays, r.n_rays_valid, r.c2w,
              r.occ_grid, r.global_step, 5, r.rcfg, r.lcfg, r.tcfg,
              r.N_iters, r.generator)
    assert _rows() - n0 == 5 * r.cfg["N_rand"] * (frame_features > 0)
