"""Empirical-Bayes likelihood estimation for dose-response data.

Counterpart of functionalmf_tpu/apps/doseresponse/empirical_bayes.py
(reference doseresponse/empirical_bayes.py:1-143). ``GammaGridLikelihood.
logpdf`` is made of torch operations with batching rules, so the model
lifts it over GASS candidates with ``torch.func.vmap``. The data comes
from a CSV read with the standard ``csv`` module into a dict of columns
(``read_csv_columns``; the JAX package reads it with pandas), and
``estimate_likelihood`` takes that dict.

The Poisson histogram GLM (reference lines 94-105 via statsmodels) is a
4-parameter polynomial Poisson regression, fitted by a small Newton/IRLS
loop.
"""
from __future__ import annotations

import csv
import math
from collections import defaultdict

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import resolve_device

__all__ = ["GammaGridLikelihood", "estimate_likelihood", "poisson_glm_fit",
           "read_csv_columns"]


def read_csv_columns(filename):
    """A CSV with a header row as ``{column: list}``: ``cell line`` and
    ``drug`` as strings, ``concentration`` and ``outcome`` as floats (an
    empty field is NaN), any other column as strings."""
    with open(filename, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {name: [] for name in header}
        for row in reader:
            for name, field in zip(header, row):
                if name in ("concentration", "outcome"):
                    field = float(field) if field != "" else math.nan
                cols[name].append(field)
    return cols


def _unique(values):
    """Distinct values in order of first appearance."""
    return list(dict.fromkeys(values))


class GammaGridLikelihood:
    """Gamma mixture over a grid of initial-population means (reference
    empirical_bayes.py:9-36).

    ``logpdf(y, effect)`` mixes Gamma(shape_g, scale_g * effect) over the
    grid components g, where shape and scale give each component the mean
    ``mean_grid[g] * effect`` and the given variance. The grid constants
    (``lgamma(shape)``, ``log(probs)``) are computed in float64 on the
    host and held in float32 on ``device``, which the caller names
    (``"cuda"`` raises without a card).
    """

    def __init__(self, mean_grid, mean_probs, variance, *, device):
        mean_grid = np.asarray(mean_grid, dtype=np.float64)
        probs = np.asarray(mean_probs, dtype=np.float64)
        shape = mean_grid ** 2 / variance
        self.mean_grid, self.mean_probs = mean_grid, probs
        self.variance = float(variance)
        self._host = dict(
            shape_grid=shape, scale_grid=variance / mean_grid,
            probs_grid=probs,
            lgamma_shape=np.array([math.lgamma(a) for a in shape]),
            log_probs=np.log(probs))
        self.to(device)

    def to(self, device):
        """Move the grid constants to ``device``; returns self."""
        self.device = resolve_device(device)
        for name, v in self._host.items():
            setattr(self, name, torch.as_tensor(
                v.astype(np.float32), device=self.device))
        return self

    def logpdf(self, y, effect):
        """y: (..., R) replicates, NaN = missing; effect: (...). Returns
        (...): the Gamma log-densities summed over the replicates per
        component, then ``logsumexp`` over the components with weights
        ``probs`` (reference empirical_bayes.py:15-31).

        The replicates enter through three statistics of each cell, taken
        before the effect: n, the count of present (non-NaN) replicates,
        S_log = sum log y and S_y = sum y over them, with y clamped at
        1e-12. Per component g, with shape a_g and scale s_g =
        max(scale_grid_g * effect, 1e-12),

            sum_r log Gamma(y_r; a_g, s_g)
                = (a_g - 1) S_log - S_y / s_g - n (lgamma a_g + a_g log s_g),

        so only (..., G)-wide work follows the effect: lifted over
        candidates with the data unbatched, the statistics are taken once
        an item. A cell with no replicate present gives
        ``logsumexp(log probs)`` for any finite effect. float32 throughout.
        """
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device) \
            if not isinstance(y, torch.Tensor) else y.float()
        effect = torch.as_tensor(
            effect, dtype=torch.float32, device=self.device) \
            if not isinstance(effect, torch.Tensor) else effect
        shapes = self.shape_grid                       # (G,)
        y_safe = torch.clamp(y, min=1e-12)             # NaN stays NaN
        n = (~torch.isnan(y)).sum(-1, keepdim=True, dtype=torch.float32)
        s_log = torch.nansum(torch.log(y_safe), -1, keepdim=True)
        s_y = torch.nansum(y_safe, -1, keepdim=True)   # (..., 1)
        # the terms free of the effect, (..., G)
        fixed = ((shapes - 1.0) * s_log - n * self.lgamma_shape
                 + self.log_probs)
        scale = torch.clamp(self.scale_grid * effect[..., None], min=1e-12)
        # fixed - S_y / s - n a log s, in two passes over (..., G)
        comp = torch.addcdiv(fixed, s_y, scale, value=-1.0)
        comp = torch.addcmul(comp, n * shapes, torch.log(scale), value=-1.0)
        return torch.logsumexp(comp, dim=-1)

    def sample(self, effect, size=1, rng=None):
        """Posterior-predictive draws (reference empirical_bayes.py:33-36)."""
        rng = np.random.default_rng() if rng is None else rng
        probs = self._host["probs_grid"]
        idx = rng.choice(probs.shape[0], size=size, p=probs / probs.sum())
        shapes = self._host["shape_grid"][idx]
        scales = self._host["scale_grid"][idx]
        return rng.gamma(shapes, scales * np.asarray(effect))


def poisson_glm_fit(counts, K=3, max_iter=100, tol=1e-10):
    """K-th order polynomial Poisson regression by Newton/IRLS (in place of
    statsmodels' GLM at reference empirical_bayes.py:97-105). Returns the
    fitted values exp(X beta)."""
    counts = np.asarray(counts, dtype=float)
    X = np.array([np.arange(len(counts)) ** k for k in range(K + 1)],
                 dtype=float).T
    Xs = X / np.linalg.norm(X, axis=0)     # unit columns: stable steps
    beta = np.linalg.lstsq(Xs, np.log(counts + 0.5), rcond=None)[0]
    for _ in range(max_iter):
        mu = np.exp(np.clip(Xs @ beta, -30, 30))
        grad = Xs.T @ (counts - mu)
        H = Xs.T @ (Xs * mu[:, None]) + 1e-10 * np.eye(K + 1)
        step = np.linalg.solve(H, grad)
        beta = beta + step
        if np.max(np.abs(step)) < tol:
            break
    return np.exp(np.clip(Xs @ beta, -30, 30))


def estimate_likelihood(df, nbins=50, control_mean=1, tensor_outcomes=False,
                        verbose=True, *, device):
    """The empirical-Bayes construction (reference empirical_bayes.py:
    39-137): control renormalisation, harvesting of the no-effect
    first-dose means, the Poisson histogram prior, the symmetrised grid.
    ``df`` is a dict of columns (``read_csv_columns``). Returns (outcomes,
    likelihood, cells, drugs, concentrations, controls); the likelihood's
    constants are on ``device``, which the caller names (``"cuda"`` or
    ``"cpu"``)."""
    cells = _unique(df["cell line"])
    drugs = _unique(df["drug"])
    concentrations = sorted(c for c in set(df["concentration"])
                            if not math.isnan(c))
    if verbose:
        print("Concentration values:", concentrations)
    outcomes = defaultdict(list)
    controls = defaultdict(list)
    cell_idx = {c: i for i, c in enumerate(cells)}
    drug_idx = {d: i for i, d in enumerate(drugs)}
    conc_idx = {c: i for i, c in enumerate(concentrations)}
    for cell_name, drug_name, conc, outcome in zip(
            df["cell line"], df["drug"], df["concentration"], df["outcome"]):
        cell = cell_idx[cell_name]
        drug = drug_idx[drug_name]
        if math.isnan(conc):
            controls[(cell, drug)].append(outcome)
        else:
            outcomes[(cell, drug, conc_idx[conc])].append(outcome)

    # control renormalisation (reference :58-70)
    for cell in range(len(cells)):
        for drug in range(len(drugs)):
            if (cell, drug) not in controls:
                continue
            obs = controls[(cell, drug)]
            mu = np.mean(obs)
            for t in range(len(concentrations)):
                outcomes[(cell, drug, t)] = [
                    o * control_mean / mu for o in outcomes[(cell, drug, t)]]
            controls[(cell, drug)] = [o * control_mean / mu for o in obs]

    # mean harvesting and noise estimation (reference :72-90)
    means, noise = [], []
    for cell in range(len(cells)):
        for drug in range(len(drugs)):
            if (cell, drug) not in controls:
                continue
            obs0 = controls[(cell, drug)]
            obs1 = outcomes[(cell, drug, 0)]
            if len(obs1) > 0 and np.mean(obs1) > control_mean:
                means.append(np.mean(obs1))
            noise.extend((np.array(obs0) - control_mean) ** 2)
    means = np.array(means)
    noise = float(np.mean(noise))

    # Poisson histogram prior, symmetrised (reference :94-110)
    counts, bins = np.histogram(means, bins=nbins // 2)
    fitted = poisson_glm_fit(counts)
    mean_grid = np.concatenate([
        2 * control_mean - (bins[:-1] + bins[1:])[::-1] / 2,
        (bins[:-1] + bins[1:]) / 2])
    mean_probs = np.concatenate([fitted[::-1], fitted])
    mean_probs = mean_probs / mean_probs.sum()

    likelihood = GammaGridLikelihood(mean_grid, mean_probs, noise,
                                     device=device)

    if tensor_outcomes:
        max_replicates = max(len(o) for o in outcomes.values())
        Y = np.full((len(cells), len(drugs), len(concentrations),
                     max_replicates), np.nan)
        for (i, j, t), o in outcomes.items():
            for r, o_r in enumerate(o):
                Y[i, j, t, r] = o_r
        outcomes = Y

    return outcomes, likelihood, cells, drugs, concentrations, controls
