"""Frozen copies of the dose-response inputs: the simulator of
``apps/doseresponse/sim.py``, the empirical-Bayes Gamma grid of
``apps/doseresponse/empirical_bayes.py`` (on the simulated arrays, without
the CSV round trip, which keeps every outcome exactly), and a warm start
and EP made from the data alone, in numpy.

Kept here so that a change to the program cannot change what the benchmark
feeds it. Nothing here imports the program.
"""
import numpy as np


def _ilogit(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x)))


def simulate(k, n, m, t, r, p, n_missing, p_missing, seed):
    """The simulator (reference doseresponse/sim.py): gamma cell-count
    plates with ilogit effect curves. Returns (obs (n - n_missing, m, t+1,
    r), effects (n, m, t)); dose 0 is the control."""
    rng = np.random.default_rng(seed)
    W = rng.gamma(3, 1, size=(n, k))
    V = np.cumsum((rng.random(size=(m, t, 1))
                   <= np.linspace(0.05, 0.5, t)[None, :, None])
                  * rng.gamma(1, 0.15, size=(m, t, k)), axis=1)
    rng.normal(0, 1 / np.sqrt(k), size=(p, k))     # U, keeps the order
    effects = _ilogit(-(W[:, None, None] * V[None, :, :]).sum(axis=-1) + 3)
    means = rng.normal(1, 0.1, size=(n, m, t + 1, 1))
    scales = np.exp(rng.normal(-7, 1, size=means.shape))
    shapes = means / scales
    obs = rng.gamma(np.maximum(shapes, 1e-8), scales, size=(n, m, t + 1, r))
    obs[:, :, 1:] *= effects[..., None]
    # the row features, drawn last, are not used by the cells
    return obs[:-n_missing], effects[:-n_missing]


def poisson_glm_fit(counts, K=3, max_iter=100, tol=1e-10):
    """K-th order polynomial Poisson regression by Newton steps; the fitted
    values exp(X beta)."""
    counts = np.asarray(counts, dtype=float)
    X = np.array([np.arange(len(counts)) ** k for k in range(K + 1)],
                 dtype=float).T
    Xs = X / np.linalg.norm(X, axis=0)
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


def gamma_grid(obs, nbins, control_mean=1.0):
    """The empirical-Bayes construction: control renormalisation, the
    no-effect first-dose means, the symmetrised Poisson histogram prior.
    Returns (Y (n, m, t, r), mean_grid, mean_probs, variance)."""
    controls = obs[:, :, 0, :]
    mu = controls.mean(axis=-1)[:, :, None, None]
    Y = obs[:, :, 1:, :] * control_mean / mu
    controls = controls * control_mean / mu[..., 0]
    first = Y[:, :, 0, :].mean(axis=-1).reshape(-1)
    means = first[first > control_mean]
    noise = float(np.mean((controls.reshape(-1) - control_mean) ** 2))
    counts, bins = np.histogram(means, bins=nbins // 2)
    fitted = poisson_glm_fit(counts)
    mids = (bins[:-1] + bins[1:]) / 2
    mean_grid = np.concatenate([2 * control_mean - mids[::-1], mids])
    probs = np.concatenate([fitted[::-1], fitted])
    return Y, mean_grid, probs / probs.sum(), noise


def warm_start(Y, nembeds):
    """A start made of the data alone: every row's W the constant 1/k on
    its active embeddings (a <= row), every column's V the column's mean
    curve clipped to [0.02, 0.98] and made non-increasing, so that every
    curve constraint holds."""
    n = Y.shape[0]
    W0 = (np.arange(nembeds)[None, :] <= np.arange(n)[:, None]) / nembeds
    curve = np.clip(np.nanmean(Y, axis=(0, 3)), 0.02, 0.98)
    curve = np.minimum.accumulate(curve, axis=1)
    V0 = np.repeat(curve[:, :, None], nembeds, axis=2)
    return W0.astype(float), V0


def ep_from_fit(Y, W, V, multiplier):
    """EP centres at the fit W V^T, sigma ``multiplier`` times the fit's
    RMS error over every replicate."""
    M = (W[:, None, None] * V[None]).sum(axis=-1)
    sqerr = np.nanmean((Y - M[..., None]) ** 2, axis=-1)
    sigma = np.sqrt(np.nanmean(sqerr)) * multiplier
    return M, np.full(Y.shape[:-1], sigma)
