"""The black-box likelihood's sharded steps against the JAX package's
``shard_map`` regions: one W update and one seq V update of the
constrained model without a cell function, with EP, on a (dp=2, mp=2)
mesh (4 virtual CPU devices for JAX, 4 spawned ``gloo`` ranks for the
port), as tests/test_torch_mesh_jax.py runs them with the cell function.

The data is one tensor, so JAX enters its ``shard_map`` regions
(functionalmf_tpu/models/constrained.py:518-541, 806-834) and the user's
function gets a rank's row (column) slab and a position in it; the port
takes the slab branch too. Tolerance: atol = 1e-5."""
from tests.test_torch_mesh_jax import check_mesh_steps


def test_blackbox_sharded_steps_match_jax_shard_map_regions(tmp_path,
                                                             monkeypatch):
    outs = check_mesh_steps(tmp_path, monkeypatch, cellfn=False)
    for o in outs:
        assert o["split"] == {"W": "slab", "V": "slab"}
