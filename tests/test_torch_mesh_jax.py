"""One sharded W update and one sharded seq V update against the JAX
package's ``shard_map`` regions (functionalmf_tpu/models/constrained.py:
517-541, 805-830), on a (dp=2, mp=2) mesh in both: 4 virtual CPU devices
for JAX, 4 spawned ``gloo`` ranks for the port (tests/torch_mesh_ranks.py).

Both start from the JAX model's state (through ``load_state``), with EP
and the seq schedule (blocks of 4 and 2), and the port's draw sites give
back the draws that JAX takes from its keys (the proposal, then log u and
the Gumbel scores; a round's block normals, then its log u and Gumbels),
as the port's unsharded step tests do (tests/test_torch_constrained.py).
Tolerance: atol = 1e-5, that of the unsharded step tests.
``jax_mesh_steps`` is shared with tests/test_torch_mesh_blackbox_jax.py,
which runs the same steps through the black-box likelihood alone."""
import numpy as np

from tests.torch_mesh_ranks import (SCHEDULES, poisson_problem,
                                    rank_jax_step, spawn_ranks)


def jax_mesh_steps(monkeypatch, cellfn):
    """The JAX model's state, the draws its steps take and the W and V
    its W step and seq V step return, per chain, on a (2, 2) mesh of
    virtual CPU devices; with ``cellfn`` the fused cell function, else
    the black-box likelihood alone (whose single-tensor data JAX cuts
    into row and column slabs)."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.special import gammaln
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering
    from functionalmf_tpu.models import constrained as jconstrained
    from functionalmf_tpu.models.base import _fold
    from functionalmf_tpu.parallel.mesh import make_mesh
    from tests.test_torch_samplers import _gass_noise

    def jax_loglik(Y, WV, W, V, row=None, col=None):
        if row is not None:
            Y = Y[row]
        if col is not None:
            Y = Y[:, col]
        rate = jnp.clip(WV, 1e-8, None)
        Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
        ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
        return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))

    def jax_cellfn(y, tau):
        rate = jnp.clip(tau, 1e-8, None)
        y0 = jnp.where(jnp.isnan(y), 0.0, y)
        return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)

    n, m, T, k, nch, ngrid = 8, 8, 6, 2, 2, 12
    Y, C, W0, V0, ep = poisson_problem(0, n, m, T, k)
    cfg = dict(SCHEDULES["seq_ep"])
    cfg.pop("ep")
    jm = ConstrainedNonconjugateBayesianTensorFiltering(
        n, m, T, jax_loglik, C,
        loglikelihood_cellfn=jax_cellfn if cellfn else None,
        mesh=make_mesh(2, 2), ep_approx=ep, nembeds=k, tf_order=1,
        sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
        gass_ngrid=ngrid, seed=5, nchains=nch, **cfg)
    jm.Tau2 = np.ones(np.shape(jm.Tau2), np.float32)
    state = {k_: np.asarray(v_) for k_, v_ in jm.state.items()}
    jdata = jm.prepare_data(Y)

    drawn = []
    real = jconstrained.sample_mvn_from_precision
    monkeypatch.setattr(
        jconstrained, "sample_mvn_from_precision",
        lambda *a, **kw: drawn.append(real(*a, **kw)) or drawn[-1])
    # jitted (one compile for both chains); the proposal draw recorded
    # while tracing is returned beside the update
    w_step = jax.jit(lambda st, key: (
        jm._update_W_gass(st, jdata, key)["W"], drawn[-1]))
    v_step = jax.jit(lambda st, key: jm._update_V_gass(st, jdata, key)["V"])
    want_W, v, log_u, gum = [], [], [], []
    for c in range(nch):
        key = jax.random.PRNGKey(20 + c)
        st = {k_: v_[c] for k_, v_ in jm.state.items()}
        W_c, v_c = w_step(st, key)
        want_W.append(np.asarray(W_c))
        v.append(np.asarray(v_c) * np.asarray(jm._wmask))
        for i in range(n):
            lu, g = _gass_noise(_fold(key, 1, i), ngrid)
            log_u.append(lu)
            gum.append(g)
    w_noise = (np.asarray(log_u, np.float32), np.stack(gum))

    sizes = [4, 2]
    want_V = []
    rounds = [dict(z=[], log_u=[], gumbel=[]) for _ in sizes]
    for c in range(nch):
        key = jax.random.PRNGKey(40 + c)
        st = {k_: v_[c] for k_, v_ in jm.state.items()}
        want_V.append(np.asarray(v_step(st, key)))
        for bi, size in enumerate(sizes):
            rounds[bi]["z"].append(np.asarray(jax.random.normal(
                _fold(key, 2, bi), (m, size, k), jnp.float32)))
            for j in range(m):
                lu, g = _gass_noise(_fold(key, 3, bi, j), ngrid)
                rounds[bi]["log_u"].append(lu)
                rounds[bi]["gumbel"].append(g)
    v_noise = [(np.stack(r["z"])[:, :, None],
                np.asarray(r["log_u"], np.float32), np.stack(r["gumbel"]))
               for r in rounds]
    return (state, np.stack(v), w_noise, v_noise, np.stack(want_W),
            np.stack(want_V))


def check_mesh_steps(tmp_path, monkeypatch, cellfn):
    """The port's sharded steps on 4 ranks against JAX's; the ranks'
    outputs."""
    state, v, w_noise, v_noise, want_W, want_V = jax_mesh_steps(
        monkeypatch, cellfn)
    outs = spawn_ranks(rank_jax_step, 4, tmp_path, state, v, w_noise,
                       v_noise, cellfn)
    for o in outs:
        np.testing.assert_allclose(o["W"], want_W, atol=1e-5)
        np.testing.assert_allclose(o["V"], want_V, atol=1e-5)
    assert not np.allclose(outs[0]["W"], state["W"])
    assert not np.allclose(outs[0]["V"], state["V"])
    return outs


def test_sharded_steps_match_jax_shard_map_regions(tmp_path, monkeypatch):
    check_mesh_steps(tmp_path, monkeypatch, cellfn=True)
