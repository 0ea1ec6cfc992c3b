"""`adam_roofline.refine` and the Adam byte count it divides, on
synthetic traced slices and the refine configurations."""
import pytest

from perfbench import adam_bytes, harness, roofline

KERNEL = ("void (anonymous namespace)::adam_step_kernel"
          "(__grid_constant__ AdamArgs)")
FOREACH = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
           "<at::native::(anonymous namespace)::TensorListMetadata<3>>")


def _refine(name):
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    return dict(cfg["nerf"], **cfg["refine"])


def _ev(ts, dur, name):
    return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name,
            "args": {"stream": 7}}


@pytest.mark.parametrize("name,rows,mlp", [
    ("custom", 39_601_891, (32 * 64 + 64 + 64 * 16 + 16)
     + ((9 + 2 + 15) * 64 + 64 + 64 * 64 + 64 + 64 * 3 + 3)),
    ("ho3d", 84_133_278, (32 * 64 + 64 + 64 * 16 + 16)
     + ((9 + 15) * 64 + 64 + 64 * 64 + 64 + 64 * 3 + 3))])
def test_adam_bytes_at_the_refine_configs(name, rows, mlp):
    """28 bytes for each of the table's rows x 2 features and each MLP
    weight and bias; 6 + frame features more a frame."""
    nerf = _refine(name)
    assert roofline.step_shapes(nerf)["rows"] == rows
    assert adam_bytes.adam_elements(nerf) == rows * 2 + mlp
    ff = int(nerf["frame_features"])
    assert adam_bytes.adam_elements(nerf, 40) == rows * 2 + mlp + 40 * (6 + ff)
    assert adam_bytes.adam_bytes(nerf) == 28 * (rows * 2 + mlp)
    assert adam_bytes.adam_bound_s(nerf) == pytest.approx(
        28 * (rows * 2 + mlp) / 3.35e12)


def test_adam_bound_at_ho3d_is_1_41_ms():
    assert adam_bytes.adam_bound_s(_refine("ho3d")) == pytest.approx(
        1.4065e-3, rel=1e-4)
    assert adam_bytes.adam_bound_s(_refine("custom")) == pytest.approx(
        0.6621e-3, rel=1e-4)


def test_adam_roofline_reads_the_kernels_launches():
    """Two launches a step over two steps: the bound a step over the
    launches' device time a step; torch's foreach kernels and other
    kernels do not count."""
    read = harness.load_metric(harness.HERE, "adam_roofline.refine")
    nerf = _refine("ho3d")
    bound_us = adam_bytes.adam_bound_s(nerf) * 1e6
    ev = [_ev(0, 1600, KERNEL), _ev(1700, 2, KERNEL), _ev(2000, 500, FOREACH),
          _ev(3000, 1700, KERNEL), _ev(4800, 2, KERNEL), _ev(5000, 9, "x")]
    got = read({"events": ev, "cfg": nerf, "trace_units": 2})
    assert got == pytest.approx(100 * 2 * bound_us / (1600 + 2 + 1700 + 2))


def test_adam_roofline_is_none_without_the_kernel():
    """The parent's slice, with torch's foreach Adam: no value."""
    read = harness.load_metric(harness.HERE, "adam_roofline.refine")
    nerf = _refine("custom")
    ev = [_ev(0, 500, FOREACH), _ev(600, 400, FOREACH)]
    assert read({"events": ev, "cfg": nerf, "trace_units": 2}) is None
    assert read({"events": None, "cfg": nerf, "trace_units": 2}) is None
    assert read({"cfg": nerf}) is None
