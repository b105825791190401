"""One step of the port's GASS (grid and shrink methods) and shrinkage
slice sampler against the JAX package's, with the noise JAX itself draws
from the same key injected (gass.py:98-99, 183, 205-206 and 222;
slice1d.py:43 and 52). The new points must agree to atol=1e-5."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu.samplers.gass import gass as jgass
from functionalmf_tpu.samplers.slice1d import shrink_slice_1d as jslice
from functionalmf_tpu_torch.samplers.gass import (
    draw_gass_noise, draw_gass_shrink_noise, gass_grid, gass_shrink)
from functionalmf_tpu_torch.samplers.slice1d import shrink_slice_1d

NGRID = 20


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _gass_noise(key, ngrid):
    """The slice height's log-uniform and the Gumbel scores exactly as
    samplers/gass.py draws them from ``key``."""
    k_h, _, k_pick = jax.random.split(key, 3)
    log_u = float(jnp.log(jax.random.uniform(k_h)))
    return log_u, np.asarray(jax.random.gumbel(k_pick, (ngrid,)))


def _run_both(xs, mus, vs, jax_ll, torch_ll, jax_A, torch_A, cs, keys,
              dim_masks=None):
    want, noise = [], []
    for b, key in enumerate(keys):
        kw = {} if dim_masks is None else dict(
            dim_mask=jnp.asarray(dim_masks[b]))
        A_b = jax_A(b)
        x_new, _ = jgass(key, jnp.asarray(xs[b]), None, jax_ll, A_b,
                         jnp.asarray(cs[b]), mu=jnp.asarray(mus[b]),
                         ngrid=NGRID, v=jnp.asarray(vs[b]), **kw)
        want.append(np.asarray(x_new))
        noise.append(_gass_noise(key, NGRID))
    log_u = _t([n[0] for n in noise])
    gumbel = _t(np.stack([n[1] for n in noise]))
    got, _ = gass_grid(_t(xs), torch_ll, torch_A, _t(cs), v=_t(vs),
                       log_u=log_u, gumbel=gumbel, mu=_t(mus),
                       dim_mask=None if dim_masks is None else _t(dim_masks))
    return got.numpy(), np.stack(want)


def _gauss_ll_pair(center, scale):
    def jax_ll(c):                                    # (G, D) -> (G,)
        return -0.5 * jnp.sum(((c - center) / scale) ** 2, axis=-1)

    def torch_ll(c):                                  # (B, G, D) -> (B, G)
        return -0.5 * (((c - _t(center)) / scale) ** 2).sum(-1)
    return jax_ll, torch_ll


def _keys(n, seed=0):
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


def test_gass_dense_constraints_match_jax(rng):
    """Positivity-style constraints A = I, c = 0 in 3-D, batch of 6."""
    B, D = 6, 3
    xs = np.abs(rng.normal(1, 0.3, (B, D))).astype(np.float32)
    mus = np.abs(rng.normal(0.5, 0.2, (B, D))).astype(np.float32)
    vs = rng.normal(0, 0.8, (B, D)).astype(np.float32)
    A = np.broadcast_to(np.eye(D, dtype=np.float32), (B, D, D)).copy()
    cs = np.zeros((B, D), np.float32)
    jll, tll = _gauss_ll_pair(np.full(D, 1.2, np.float32), 0.5)
    got, want = _run_both(xs, mus, vs, jll, tll, lambda b: jnp.asarray(A[b]),
                          _t(A), cs, _keys(B))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got >= 0).all()
    assert not np.allclose(got, xs)        # the step moved somewhere


def test_gass_callable_operator_matches_jax(rng):
    """The factorised V-update operator y -> W (CA y)^T, batched."""
    B, n, J, size, k = 5, 4, 3, 3, 2
    D = size * k
    W = np.abs(rng.normal(1, 0.3, (n, k))).astype(np.float32)
    CA = np.eye(size, dtype=np.float32)[:J]
    xs = np.abs(rng.normal(1, 0.3, (B, D))).astype(np.float32)
    mus = np.abs(rng.normal(1, 0.2, (B, D))).astype(np.float32)
    vs = rng.normal(0, 0.5, (B, D)).astype(np.float32)
    cs = np.zeros((B, n * J), np.float32)

    def jax_A(b):
        def A_op(y):
            M = jnp.dot(CA, y.reshape(size, k))
            return jnp.dot(W, M.T).reshape(-1)
        return A_op

    def torch_A(Y):                                    # (B, G, D)
        M = torch.einsum("jt,bgtk->bgjk", _t(CA),
                         Y.reshape(Y.shape[0], Y.shape[1], size, k))
        return torch.einsum("nk,bgjk->bgnj", _t(W), M).reshape(
            Y.shape[0], Y.shape[1], -1)

    jll, tll = _gauss_ll_pair(np.full(D, 1.0, np.float32), 0.4)
    got, want = _run_both(xs, mus, vs, jll, tll, jax_A, torch_A, cs,
                          _keys(B, 1))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gass_dim_mask_matches_jax(rng):
    """Lower-triangular W rows: masked dims stay at 0."""
    B, D = 4, 3
    masks = np.tril(np.ones((B, D), np.float32))[:, :D]
    xs = (np.abs(rng.normal(1, 0.3, (B, D))) * masks).astype(np.float32)
    mus = np.zeros((B, D), np.float32)
    vs = rng.normal(0, 1.0, (B, D)).astype(np.float32)
    J = 5
    A = np.abs(rng.normal(1, 0.3, (B, J, D))).astype(np.float32)
    cs = np.zeros((B, J), np.float32)
    jll, tll = _gauss_ll_pair(np.full(D, 0.8, np.float32), 0.6)
    got, want = _run_both(
        xs, mus, vs, jll, tll, lambda b: jnp.asarray(A[b] * masks[b][None]),
        lambda Y: torch.einsum("bjd,bgd->bgj", _t(A), Y * _t(masks)[:, None]),
        cs, _keys(B, 2), dim_masks=masks)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[masks == 0] == 0).all()


def test_gass_stays_put_when_no_candidate_is_above_the_slice(rng):
    """A likelihood peaked at the current point rejects every grid point:
    both versions return x unchanged."""
    B, D = 3, 2
    xs = np.abs(rng.normal(1, 0.3, (B, D))).astype(np.float32)
    mus = np.zeros((B, D), np.float32)
    vs = rng.normal(0, 1.0, (B, D)).astype(np.float32)
    A = np.broadcast_to(np.eye(D, dtype=np.float32), (B, D, D)).copy()
    cs = np.zeros((B, D), np.float32)
    got, want = [], []
    for b, key in enumerate(_keys(B, 3)):
        def jll(c, b=b):
            return -1e6 * jnp.sum((c - xs[b]) ** 2, axis=-1)
        x_new, _ = jgass(key, jnp.asarray(xs[b]), None, jll,
                         jnp.asarray(A[b]), jnp.asarray(cs[b]),
                         mu=jnp.asarray(mus[b]), ngrid=NGRID,
                         v=jnp.asarray(vs[b]))
        want.append(np.asarray(x_new))
        log_u, gum = _gass_noise(key, NGRID)
        x_t, _ = gass_grid(
            _t(xs[b:b + 1]),
            lambda c, b=b: -1e6 * ((c - _t(xs[b])) ** 2).sum(-1),
            _t(A[b:b + 1]), _t(cs[b:b + 1]), v=_t(vs[b:b + 1]),
            log_u=_t([log_u]), gumbel=_t(gum[None]), mu=_t(mus[b:b + 1]))
        got.append(x_t.numpy()[0])
    np.testing.assert_array_equal(np.stack(got), xs)
    np.testing.assert_array_equal(np.stack(want), xs)


def test_draw_gass_noise_shapes_and_range():
    g = torch.Generator().manual_seed(0)
    log_u, gum = draw_gass_noise(g, 7, 11, "cpu")
    assert log_u.shape == (7,) and gum.shape == (7, 11)
    assert (log_u <= 0).all() and torch.isfinite(gum).all()


def _shrink_noise(key, max_shrink=30):
    """log u, the wrap angle and the bracket uniforms as the shrink method
    draws them from ``key`` (gass.py:98-99, 205-206, 222)."""
    k_h, _, k_pick = jax.random.split(key, 3)
    k_wrap, k_loop = jax.random.split(k_pick)
    log_u = float(jnp.log(jax.random.uniform(k_h)))
    phi = float(jax.random.uniform(k_wrap) * (2.0 * jnp.pi))
    u = [float(jax.random.uniform(jax.random.fold_in(k_loop, it)))
         for it in range(max_shrink)]
    return log_u, phi, np.asarray(u, np.float32)


def _run_both_shrink(xs, mus, vs, jax_ll, torch_ll, jax_A, torch_A, cs, keys,
                     dim_masks=None):
    want, want_ll, noise = [], [], []
    for b, key in enumerate(keys):
        kw = {} if dim_masks is None else dict(
            dim_mask=jnp.asarray(dim_masks[b]))
        x_new, ll_new = jgass(key, jnp.asarray(xs[b]), None, jax_ll, jax_A(b),
                              jnp.asarray(cs[b]), mu=jnp.asarray(mus[b]),
                              v=jnp.asarray(vs[b]), method="shrink", **kw)
        want.append(np.asarray(x_new))
        want_ll.append(float(ll_new))
        noise.append(_shrink_noise(key))
    calls = []

    def counted_ll(c):
        calls.append(tuple(c.shape))
        return torch_ll(c)

    got, got_ll = gass_shrink(
        _t(xs), counted_ll, torch_A, _t(cs), v=_t(vs),
        log_u=_t([n[0] for n in noise]), phi=_t([n[1] for n in noise]),
        u=_t(np.stack([n[2] for n in noise])), mu=_t(mus),
        dim_mask=None if dim_masks is None else _t(dim_masks))
    np.testing.assert_allclose(got_ll.numpy(), want_ll, rtol=1e-4, atol=1e-4)
    return got.numpy(), np.stack(want), calls


def test_gass_shrink_with_interval_constraints_matches_jax(rng):
    """Positivity constraints in 3-D, batch of 8, a likelihood much
    narrower than the proposal: several shrink iterations, items done at
    different iterations (a done item must ignore the later ones), one
    candidate an item a call."""
    B, D = 8, 3
    xs = np.abs(rng.normal(1, 0.3, (B, D))).astype(np.float32)
    mus = np.abs(rng.normal(0.5, 0.2, (B, D))).astype(np.float32)
    vs = rng.normal(0, 0.8, (B, D)).astype(np.float32)
    A = np.broadcast_to(np.eye(D, dtype=np.float32), (B, D, D)).copy()
    cs = np.zeros((B, D), np.float32)
    jll, tll = _gauss_ll_pair(np.full(D, 1.2, np.float32), 0.1)
    got, want, calls = _run_both_shrink(
        xs, mus, vs, jll, tll, lambda b: jnp.asarray(A[b]), _t(A), cs,
        _keys(B, 5))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got >= 0).all()
    assert (np.abs(got - xs).max(axis=1) > 0).all()     # shrink always moves
    assert set(calls) == {(B, 1, D)} and 3 < len(calls) < 31


def test_gass_shrink_full_circle_uses_the_randomised_wrap(rng):
    """No constraint is an interval constraint (c far below): the bracket
    is [phi - 2 pi, phi]."""
    B, D = 6, 2
    xs = rng.normal(0, 1, (B, D)).astype(np.float32)
    mus = np.zeros((B, D), np.float32)
    vs = rng.normal(0, 1.0, (B, D)).astype(np.float32)
    A = np.broadcast_to(np.eye(D, dtype=np.float32), (B, D, D)).copy()
    cs = np.full((B, D), -100.0, np.float32)
    jll, tll = _gauss_ll_pair(np.full(D, 0.3, np.float32), 0.2)
    got, want, _ = _run_both_shrink(
        xs, mus, vs, jll, tll, lambda b: jnp.asarray(A[b]), _t(A), cs,
        _keys(B, 6))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gass_shrink_callable_operator_and_dim_mask_match_jax(rng):
    B, D, J = 5, 3, 4
    masks = np.tril(np.ones((B, D), np.float32))[:, :D]
    masks[3:] = 1.0
    xs = (np.abs(rng.normal(1, 0.3, (B, D))) * masks).astype(np.float32)
    mus = np.zeros((B, D), np.float32)
    vs = rng.normal(0, 1.0, (B, D)).astype(np.float32)
    A = np.abs(rng.normal(1, 0.3, (B, J, D))).astype(np.float32)
    cs = np.zeros((B, J), np.float32)
    jll, tll = _gauss_ll_pair(np.full(D, 0.8, np.float32), 0.3)
    got, want, _ = _run_both_shrink(
        xs, mus, vs, jll, tll,
        lambda b: (lambda y, b=b: jnp.dot(jnp.asarray(A[b] * masks[b][None]),
                                          y)),
        lambda Y: torch.einsum("bjd,bgd->bgj", _t(A), Y * _t(masks)[:, None]),
        cs, _keys(B, 7), dim_masks=masks)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[masks == 0] == 0).all()


def test_gass_shrink_hits_the_iteration_bound_and_stays_put(rng):
    """A likelihood that rejects everything but the current point: after
    max_shrink iterations both versions return x."""
    B, D = 3, 2
    xs = np.abs(rng.normal(1, 0.3, (B, D))).astype(np.float32)
    A = np.broadcast_to(np.eye(D, dtype=np.float32), (B, D, D)).copy()
    cs = np.zeros((B, D), np.float32)
    vs = rng.normal(0, 1.0, (B, D)).astype(np.float32)
    log_u, phi, u = draw_gass_shrink_noise(torch.Generator().manual_seed(0),
                                           B, 5, "cpu")
    assert log_u.shape == phi.shape == (B,) and u.shape == (B, 5)
    assert (phi >= 0).all() and (phi <= 2 * np.pi).all()
    calls = []

    def ll(c):
        calls.append(1)
        return torch.where(((c - _t(xs)[:, None]) ** 2).sum(-1) == 0, 0.0,
                           -torch.inf)

    got, _ = gass_shrink(_t(xs), ll, _t(A), _t(cs), v=_t(vs), log_u=log_u,
                         phi=phi, u=u)
    np.testing.assert_array_equal(got.numpy(), xs)
    assert len(calls) == 1 + 5


def _slice_noise(key, max_shrink):
    """Exp(1) and the per-iteration uniforms as slice1d.py draws them."""
    k_y, k_u = jax.random.split(key)
    e = float(jax.random.exponential(k_y))
    us, k = [], k_u
    for _ in range(max_shrink):
        k, sub = jax.random.split(k)
        us.append(float(jax.random.uniform(sub, dtype=jnp.float32)))
    return e, np.asarray(us, np.float32)


@pytest.mark.parametrize("sharp,max_shrink,x0", [
    (1.0, 16, [0.3, -1.0, 2.0, 0.0, 1.5]),
    (400.0, 16, [0.3, -1.0, 2.0, 0.0, 1.5]),
    (1e6, 2, [0.5, 0.5, 0.5001, 0.4999, 0.5])])
def test_shrink_slice_1d_matches_jax(sharp, max_shrink, x0):
    """A broad target (accepts at once), a sharp one (several shrinks)
    and a cap that is hit at the mode (stays put, accepted False); batch
    of 5."""
    x0 = np.array(x0, np.float32)
    lo, hi = -4.0, 5.0

    def jld(x):
        return -0.5 * sharp * (x - 0.5) ** 2

    keys = _keys(len(x0), 4)
    want_x, want_acc, es, us = [], [], [], []
    for b, key in enumerate(keys):
        x, acc = jslice(key, jnp.float32(x0[b]), jld, lo, hi,
                        max_shrink=max_shrink)
        want_x.append(float(x))
        want_acc.append(bool(acc))
        e, u = _slice_noise(key, max_shrink)
        es.append(e)
        us.append(u)
    got_x, got_acc = shrink_slice_1d(
        _t(x0), lambda x: -0.5 * sharp * (x - 0.5) ** 2, lo, hi,
        max_shrink=max_shrink, noise=(_t(es), _t(np.stack(us, 1))))
    np.testing.assert_allclose(got_x.numpy(), want_x, atol=1e-5)
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)
    if max_shrink == 2:
        assert not all(want_acc)
        stay = ~np.asarray(want_acc)
        np.testing.assert_array_equal(got_x.numpy()[stay], x0[stay])


def test_shrink_slice_1d_targets_its_density():
    """Moment check with the port's own draws: many chains of one step
    from exact N(0.5, 1) draws stay N(0.5, 1) on a wide bracket."""
    g = torch.Generator().manual_seed(1)
    x = 0.5 + torch.randn(40000, generator=g)
    for _ in range(3):
        x, _ = shrink_slice_1d(x, lambda z: -0.5 * (z - 0.5) ** 2, -9.5,
                               10.5, gen=g)
    assert abs(float(x.mean()) - 0.5) < 0.03
    assert abs(float(x.std()) - 1.0) < 0.03
