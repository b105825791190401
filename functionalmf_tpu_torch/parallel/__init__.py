"""Mesh sharding of the BTF state over ``torch.distributed``
(``parallel/mesh.py``)."""
from functionalmf_tpu_torch.parallel.mesh import (
    DP_AXIS, MP_AXIS, Mesh, feasible_spec, gather_state, init_distributed,
    make_mesh, shard_state, state_specs)

__all__ = ["DP_AXIS", "MP_AXIS", "Mesh", "init_distributed", "make_mesh",
           "feasible_spec", "state_specs", "shard_state", "gather_state"]
