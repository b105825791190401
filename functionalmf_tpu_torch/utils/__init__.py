"""Host-side support utilities (initialisers, projections, metrics, EP),
the surface of functionalmf_tpu/utils/__init__.py from the port's own
modules."""

from functionalmf_tpu_torch.utils.metrics import (
    ilogit, mse, mae, moving_average, cross_entropy, random_holdouts,
    coverage_at,
)
from functionalmf_tpu_torch.utils.pav import pav, factor_pav
from functionalmf_tpu_torch.utils.nmf import tensor_nmf
from functionalmf_tpu_torch.utils.ep import grid_ep_approx, ep_from_mf
from functionalmf_tpu_torch.utils.binary_mf import (
    binary_mf, logistic_regression_loss, logistic_regression_grad,
)

# the penalty matrices, as the reference's functionalmf.utils has them
# (utils.py:56-98)
from functionalmf_tpu_torch.ops.penalty import (
    bayes_delta, bayes_grid_penalty, get_delta, grid_penalty_matrix,
    hypercube_edges, matrix_from_edges,
)

__all__ = [
    "ilogit", "mse", "mae", "moving_average", "cross_entropy",
    "random_holdouts", "coverage_at", "pav", "factor_pav", "tensor_nmf",
    "grid_ep_approx", "ep_from_mf", "binary_mf",
    "logistic_regression_loss", "logistic_regression_grad",
    "bayes_delta", "bayes_grid_penalty", "get_delta", "grid_penalty_matrix",
    "hypercube_edges", "matrix_from_edges",
]
