"""The port's MCMC diagnostics against the JAX package's on identical
draws: the same numpy arithmetic, so they agree to float64 rounding."""
import numpy as np
import pytest

from functionalmf_tpu.utils import diagnostics as jd
from functionalmf_tpu_torch.utils import diagnostics as td


def _ar1(rng, n, phi):
    x = np.zeros(n)
    e = rng.normal(size=n)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + e[i]
    return x


def _chains():
    rng = np.random.default_rng(0)
    return {"iid": rng.normal(size=1000),
            "ar1 0.5": _ar1(rng, 1000, 0.5),
            "ar1 0.95": _ar1(rng, 2000, 0.95),
            "constant": np.full(500, 3.0),
            "short": rng.normal(size=3),
            "anti-correlated": _ar1(rng, 1000, -0.6)}


@pytest.mark.parametrize("name", list(_chains()))
def test_effective_sample_size_matches_jax(name):
    x = _chains()[name]
    got, want = td.effective_sample_size(x), jd.effective_sample_size(x)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert 1.0 <= got <= len(x)
    if name == "ar1 0.95":      # ESS ~ n (1 - phi) / (1 + phi)
        assert got < 0.1 * len(x)


def _samples(rng, S=200):
    """run_gibbs-shaped draws: W wide enough that 512 of its columns are a
    sample, V narrower, scalars as (S, 1)."""
    W = np.cumsum(rng.normal(size=(S, 30, 20)), axis=0) * 0.1 \
        + rng.normal(size=(S, 30, 20))
    return {"W": W, "V": rng.normal(size=(S, 4, 6, 2)),
            "lam2": _ar1(rng, S, 0.9)[:, None],
            "sigma2": rng.gamma(2.0, 1.0, (S, 1))}


@pytest.mark.parametrize("detail", [False, True])
def test_min_ess_per_param_matches_jax(detail):
    s = _samples(np.random.default_rng(1))
    got = td.min_ess_per_param(s, detail=detail)
    want = jd.min_ess_per_param(s, detail=detail)
    if detail:
        assert got[1:] == want[1:]
        got, want = got[0], want[0]
    assert got == pytest.approx(want, rel=1e-12)
    # an rng of the caller's, and keys the dict lacks
    kw = dict(keys=("V", "lam2", "nu2"), max_params=5)
    assert td.min_ess_per_param(s, rng=np.random.default_rng(4), **kw) == \
        pytest.approx(jd.min_ess_per_param(s, rng=np.random.default_rng(4),
                                           **kw), rel=1e-12)


@pytest.mark.parametrize("detail", [False, True])
def test_pooled_min_ess_matches_jax(detail):
    s = _samples(np.random.default_rng(2), S=4 * 80)
    got = td.pooled_min_ess(s, 4, detail=detail)
    want = jd.pooled_min_ess(s, 4, detail=detail)
    if detail:
        assert got[1:] == want[1:]
        got, want = got[0], want[0]
    assert got == pytest.approx(want, rel=1e-12)
    with pytest.raises(ValueError, match="chains"):
        td.pooled_min_ess(s, 3)


def test_split_rhat_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 101)) + np.arange(4)[:, None] * 0.3
    assert td.split_rhat(x) == pytest.approx(jd.split_rhat(x), rel=1e-12)
