"""The port's Gibbs driver (functionalmf_tpu_torch/models/base.py:
run_gibbs): chunked and unchunked runs draw the same stream, the results
dict carries the JAX package's keys and shapes, and split-R-hat comes
with several chains."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering \
    as JaxModel
from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as TorchModel, POISSON)

N, M, T, K = 4, 3, 9, 2


def _data():
    rng = np.random.default_rng(2)
    W = np.abs(rng.normal(1, 0.3, (N, K)))
    W[np.triu_indices(K, 1)] = 0
    V = np.abs(rng.normal(1, 0.3, (M, T, K)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    Y[1, 2] = np.nan
    C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (N, K)))
    W0[np.triu_indices(K, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (M, T, K)))
    return Y, C, dict(nembeds=K, tf_order=1, sigma2_init=0.5, lam2_init=0.1,
                      W_init=W0, V_init=V0, gass_ngrid=12, v_block_size=3,
                      v_schedule="redblack", seed=4)


def _torch_loglik(Y, WV, W, V, row=None, col=None):
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    return torch.where(nan, 0.0, torch.where(nan, 0.0, Y) * torch.log(rate)
                       - rate).sum()


def _torch_model(nchains=1):
    Y, C, kw = _data()
    return TorchModel(N, M, T, _torch_loglik, C, device="cpu",
                      loglikelihood_cellfn=POISSON, nchains=nchains,
                      **kw), Y


def test_chunked_and_unchunked_runs_are_stream_identical():
    res = {}
    for tag, cap in (("big", None), ("small", 3)):
        m, Y = _torch_model()
        if cap is not None:
            m.max_sweeps_per_call = cap
        res[tag] = m.run_gibbs(Y, nburn=5, nthin=4, nsamples=3,
                               verbose=False)
    for key in ("W", "V", "lam2", "sigma2", "Tau2"):
        np.testing.assert_array_equal(res["big"][key], res["small"][key])


def test_same_seed_same_draws_and_runs_continue_from_state():
    a, Y = _torch_model()
    b, _ = _torch_model()
    ra = a.run_gibbs(Y, nburn=3, nthin=1, nsamples=2, verbose=False)
    rb = b.run_gibbs(Y, nburn=3, nthin=1, nsamples=2, verbose=False)
    np.testing.assert_array_equal(ra["V"], rb["V"])
    np.testing.assert_array_equal(a.V, ra["V"][-1])
    rc = a.run_gibbs(Y, nburn=0, nthin=1, nsamples=1, verbose=False)
    assert not np.array_equal(rc["V"][0], ra["V"][-1])


def test_results_keys_and_shapes_match_jax():
    Y, C, kw = _data()

    def jax_loglik(Yd, WV, W, V, row=None, col=None):
        rate = jnp.clip(WV, 1e-8, None)
        Y0 = jnp.where(jnp.isnan(Yd), 0.0, Yd)
        return jnp.sum(jnp.where(jnp.isnan(Yd), 0.0,
                                 Y0 * jnp.log(rate) - rate))

    def jax_cellfn(y, tau):
        rate = jnp.clip(tau, 1e-8, None)
        y0 = jnp.where(jnp.isnan(y), 0.0, y)
        return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)

    jm = JaxModel(N, M, T, jax_loglik, C, loglikelihood_cellfn=jax_cellfn,
                  nchains=2, **kw)
    want = jm.run_gibbs(Y, nburn=1, nthin=1, nsamples=4, verbose=False)
    tm, _ = _torch_model(nchains=2)
    got = tm.run_gibbs(Y, nburn=1, nthin=1, nsamples=4, verbose=False)
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "rhat":
            assert set(got[key]) == set(val)
        else:
            assert got[key].shape == np.shape(val), key
            assert got[key].dtype == np.asarray(val).dtype, key
    assert set(tm.state) == set(jm.state)
    for key, val in jm.state.items():
        assert tuple(tm.state[key].shape) == tuple(val.shape), key


def test_rhat_only_with_several_chains():
    m2, Y = _torch_model(nchains=2)
    res = m2.run_gibbs(Y, nburn=4, nthin=1, nsamples=8, verbose=False)
    rhat = res["rhat"]
    assert set(rhat) >= {"W", "V", "lam2", "sigma2", "max"}
    assert np.isfinite(rhat["max"]) and rhat["max"] >= 1.0 - 1e-6
    assert rhat["max"] == max(v for k, v in rhat.items() if k != "max")
    # chains draw different streams
    assert not np.array_equal(res["V"][:8], res["V"][8:])
    m1, _ = _torch_model()
    assert "rhat" not in m1.run_gibbs(Y, nburn=2, nthin=1, nsamples=5,
                                      verbose=False)


def test_out_of_slice_driver_options_raise():
    m, Y = _torch_model()
    with pytest.raises(NotImplementedError, match="callback"):
        m.run_gibbs(Y, nburn=1, nsamples=1, callback=lambda *a: None)
    with pytest.raises(NotImplementedError, match="checkpoint_path"):
        m.run_gibbs(Y, nburn=1, nsamples=1, checkpoint_path="x")


def test_device_is_required():
    """A model built without ``device=`` runs on the card: where there is
    none it raises, and never falls back to the CPU."""
    Y, C, kw = _data()
    if torch.cuda.is_available():
        m = TorchModel(N, M, T, _torch_loglik, C,
                       loglikelihood_cellfn=POISSON, **kw)
        assert m.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchModel(N, M, T, _torch_loglik, C, loglikelihood_cellfn=POISSON,
                   **kw)
