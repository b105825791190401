"""Carry a model state between the JAX package and the port.

``state_from_numpy`` takes ``{k: np.asarray(v) for k, v in
jax_model.state.items()}`` and returns the port's state dict on
``device`` (with ``mesh``, this rank's slices of it: ``parallel/mesh.py:
shard_state``); ``state_to_numpy`` goes the other way. Under a mesh
``Model.load_state`` takes the global numpy state as well and keeps this
rank's slices, and ``state_to_numpy(model.state)`` gives it back whole
(``model.state`` gathers it on every rank). With
``Model.load_state`` both packages then compute from the same W, V, Tau2,
lam2 and sigma2, and from the same ``nu2`` (Gaussian, Binomial, NegBinom)
and ``R`` (NegBinom), which cross as every other entry does. Keys and
shapes are the same in both: every entry has a leading chain axis. Values
cross unchanged, non-finite ones too: the Binomial ``nu2`` = 1 / omega is
``inf`` at cells without data. EP centres are not state: give both models
the same ``ep_approx``. The constrained model's ``Row_constraints`` are
state and cross with it (chain axis included). The prepared data of a
black-box model, a pytree of arrays that a per-sweep hook may rewrite
(the dose-response ``{"Y", "X", "U"}``), crosses through
``data_from_numpy`` / ``data_to_numpy``. ``gamma_grid_likelihood`` builds
the port's dose-response likelihood from the numpy ``(mean_grid,
mean_probs, variance)`` the JAX package's is built from, so that both
evaluate the same mixture. A BNP-CovReg state (``theta``, ``zeta``,
``psi``, ``xi``, ``phi``, ``delta``, ``invSig``; no chain axis,
apps/flutrends/bnp_covreg.py) crosses through ``state_from_numpy`` /
``state_to_numpy`` as well.
"""
from __future__ import annotations

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import tree_map

__all__ = ["state_from_numpy", "state_to_numpy", "data_from_numpy",
           "data_to_numpy", "gamma_grid_likelihood"]


def state_from_numpy(np_state, device, mesh=None, specs=None):
    """The state as float32 tensors on ``device``; with ``mesh``, this
    rank's slices by ``specs`` (a model's ``state_partition_specs()``;
    chains only without)."""
    state = {k: torch.as_tensor(np.array(v, dtype=np.float32),
                                device=torch.device(device))
             for k, v in np_state.items()}
    if mesh is None:
        return state
    from functionalmf_tpu_torch.parallel.mesh import shard_state
    return shard_state(state, mesh, specs)


def state_to_numpy(state):
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def data_from_numpy(np_data, device):
    """A pytree of arrays (``jax.device_get`` of the JAX model's prepared
    data) as float32 tensors on ``device``, structure kept."""
    return tree_map(lambda v: torch.as_tensor(
        np.array(v, dtype=np.float32), device=torch.device(device)), np_data)


def data_to_numpy(pdata):
    return tree_map(lambda v: v.detach().float().cpu().numpy(), pdata)


def gamma_grid_likelihood(mean_grid, mean_probs, variance, *, device):
    """The port's ``GammaGridLikelihood`` of the same grid, on ``device``."""
    from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
        GammaGridLikelihood)
    return GammaGridLikelihood(mean_grid, mean_probs, variance,
                               device=device)
