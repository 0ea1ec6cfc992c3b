"""The port's public surface against the JAX package's, name by name.

Both packages' sources are walked as ASTs: every module's public
top-level functions and classes, and the public methods and properties of
its public classes, keyed `module path::name` (`ops/sampling.py::
sample_occupied_steps`, `gui.py::DpgGui.close`). Every JAX name must have
a counterpart of the same key in the port, or one under another name
(`RENAMED`, which must exist in the port), or stand in `LEFT_OUT` with the
reason ROADMAP.md gives under "Left out on purpose". A name added to the
JAX package, or one dropped from the port, fails here.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX name -> the port's counterpart under another name
RENAMED = {
    "ops/scatter.py::scatter_rows_sorted_tiles":
        "ops/scatter.py::scatter_rows",   # the Pallas kernel, csrc/*.cu
    "parallel/dp.py::make_ray_mesh": "parallel/dp.py::make_ray_devices",
}

# JAX name -> why the port has no counterpart (ROADMAP "Left out on purpose")
_FUNCTIONAL_NOF = ("the functional parameter API; `NofField` and "
                   "`params_from_jax` replace it")
_FUNCTIONAL_LOFTR = ("the functional parameter API; the `LoFTR` module, "
                     "`load_reference_state_dict` and `params_from_jax` "
                     "replace it")
LEFT_OUT = {
    "nof/models.py::init_nof_params": _FUNCTIONAL_NOF,
    "nof/models.py::nof_forward": _FUNCTIONAL_NOF,
    "nof/models.py::nof_sdf": _FUNCTIONAL_NOF,
    "matcher/loftr.py::init_loftr_params": _FUNCTIONAL_LOFTR,
    "matcher/loftr.py::loftr_forward": _FUNCTIONAL_LOFTR,
    "matcher/loftr.py::loftr_forward_batch": _FUNCTIONAL_LOFTR,
    "matcher/loftr.py::backbone_forward": _FUNCTIONAL_LOFTR,
    "matcher/loftr.py::convert_torch_state_dict": _FUNCTIONAL_LOFTR,
    "ops/scatter.py::scatter_rows_xla":
        "a TPU scatter engine (sort / tile / one-hot)",
    "ops/scatter.py::scatter_rows_dense_onehot":
        "a TPU scatter engine (sort / tile / one-hot)",
    "ops/hashgrid.py::run_overflow_fractions":
        "telemetry of the TPU-only `k_runs` run budget",
    "ops/hashgrid.py::HashGridSpec.run_budget":
        "the TPU-only `k_runs` run budget",
    "ops/occupancy.py::OccupancyGrid.tree_flatten":
        "JAX pytree registration",
    "ops/occupancy.py::OccupancyGrid.tree_unflatten":
        "JAX pytree registration",
    "tracker/pool.py::covis_slots":
        "a jit wrapper; the port calls `covis_core` directly",
    "tracker/pool.py::gather_slots":
        "a jit wrapper; the port calls `covis_core` directly",
}


def public_names(package):
    """{`module path::name`} of @package's public functions, classes and
    their public methods and properties."""
    out = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, package)):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, os.path.join(ROOT, package))
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef))
                        and not node.name.startswith("_")):
                    out.add(f"{mod}::{node.name}")
                    if isinstance(node, ast.ClassDef):
                        out |= {f"{mod}::{node.name}.{m.name}"
                                for m in node.body
                                if isinstance(m, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef))
                                and not m.name.startswith("_")}
    return out


@pytest.fixture(scope="module")
def names():
    return public_names("bundlesdf_tpu"), public_names("bundlesdf_tpu_torch")


def test_every_jax_name_has_a_counterpart(names):
    jax_names, port_names = names
    missing = jax_names - port_names
    assert missing == set(RENAMED) | set(LEFT_OUT), (
        f"without a counterpart and not listed: "
        f"{sorted(missing - set(RENAMED) - set(LEFT_OUT))}; listed but "
        f"present in the port or gone from JAX: "
        f"{sorted(set(RENAMED) | set(LEFT_OUT) - missing)}")
    assert set(RENAMED.values()) <= port_names
    assert all(LEFT_OUT.values())


@pytest.mark.parametrize("name", [
    "gui.py::DpgGui", "gui.py::DpgGui.clean_mesh", "gui.py::DpgGui.close",
    "gui.py::DpgGui.drag_move_pose", "gui.py::DpgGui.drag_rotate_pose",
    "gui.py::DpgGui.export_mesh", "gui.py::DpgGui.reset_mesh_view",
    "gui.py::DpgGui.set_nerf_num_frames", "gui.py::DpgGui.update_frame",
    "gui.py::DpgGui.update_mesh", "matcher/classical.py::OrbMatcher.predict",
    "ops/sampling.py::sample_occupied_steps",
    "ops/occupancy.py::OccupancyGrid.voxel_size"])
def test_the_last_ported_names(names, name):
    jax_names, port_names = names
    assert name in jax_names and name in port_names


def test_the_walk_sees_both_packages(names):
    jax_names, port_names = names
    for n in ("nof/runner.py::NofRunner.train", "bundlesdf.py::BundleSdf",
              "ops/occupancy.py::ray_trace_occupancy"):
        assert n in jax_names and n in port_names
    assert len(jax_names) > 200 and len(port_names) > 200
