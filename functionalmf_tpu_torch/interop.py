"""Carry a model state between the JAX package and the port.

``state_from_numpy`` takes ``{k: np.asarray(v) for k, v in
jax_model.state.items()}`` and returns the port's state dict on
``device``; ``state_to_numpy`` goes the other way. With
``Model.load_state`` both packages then compute from the same W, V, Tau2,
lam2 and sigma2, and from the same ``nu2`` (Gaussian, Binomial, NegBinom)
and ``R`` (NegBinom), which cross as every other entry does. Keys and
shapes are the same in both: every entry has a leading chain axis. Values
cross unchanged, non-finite ones too: the Binomial ``nu2`` = 1 / omega is
``inf`` at cells without data. EP centres are not state: give both models
the same ``ep_approx``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(np_state, device):
    return {k: torch.as_tensor(np.array(v, dtype=np.float32),
                               device=torch.device(device))
            for k, v in np_state.items()}


def state_to_numpy(state):
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
