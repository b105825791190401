"""Spawned ``gloo`` ranks for the port's mesh tests, and the problems they
run. This module imports torch, numpy and the port only: the spawned
ranks import it (and never jax).

``spawn_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), each joining a ``gloo`` group through
a ``file://`` rendezvous in ``tmp_path`` (no port to collide on between
test workers), runs ``fn(rank, *args)`` and returns the ranks' results in
rank order. Past its deadline every process is killed and it raises.
"""
from __future__ import annotations

import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as tmp_mp

DEADLINE_S = 120.0


def _rank_entry(fn, rank, world, url, out, args, deadline):
    torch.set_num_threads(1)
    try:
        from functionalmf_tpu_torch.parallel.mesh import init_distributed
        init_distributed(url, world, rank, backend="gloo",
                         timeout_s=deadline)
        res = fn(rank, *args)
        out.put((rank, "ok", res))
    except BaseException:                                    # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world, tmp_path, *args, deadline=DEADLINE_S):
    ctx = tmp_mp.get_context("spawn")
    out = ctx.Queue()
    url = "file://" + os.path.join(str(tmp_path),
                                   f"rdv_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, url, out, args, deadline))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    stop = time.monotonic() + deadline
    try:
        while len(results) + len(errors) < world:
            left = stop - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not finish within {deadline} s")
            try:
                rank, status, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"a rank died: exit codes {[p.exitcode for p in procs]}")
                continue
            if status == "ok":
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise RuntimeError("\n".join(errors))
        for p in procs:
            p.join(timeout=10)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [results[r] for r in range(world)]


# ----------------------------------------------------------------------
# problems (JAX's test shape: tests/test_parallel.py:87-138)
# ----------------------------------------------------------------------
def torch_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    Y0 = torch.where(nan, 0.0, Y)
    ll = Y0 * torch.log(rate) - rate - torch.lgamma(Y0 + 1.0)
    return torch.where(nan, 0.0, ll).sum()


def poisson_problem(seed=0, n=8, m=8, T=6, k=2):
    rng = np.random.default_rng(seed)
    W0 = np.abs(rng.normal(1, 0.2, (n, k)))
    W0[np.triu_indices(k, 1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, (m, T, k)))
    Mu = np.einsum("nk,mtk->nmt", W0, V0)
    Y = rng.poisson(Mu).astype(np.float64)
    Y[0, 1, 2] = np.nan
    C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
    ep = (Mu + rng.normal(0, 0.1, Mu.shape), rng.uniform(1.5, 2.5, Mu.shape))
    return Y, C, W0, V0, ep


SCHEDULES = {
    "redblack": dict(v_schedule="redblack", v_block_size=2),
    "seq_ep": dict(v_schedule="seq", v_block_size=4, ep=True),
    "joint": dict(v_schedule="seq", v_block_size=None),
}


def constrained_model(schedule, mesh=None, n=8, m=8, T=6, k=2, nchains=2,
                      seed=5, cellfn=True, device="cpu", **kw):
    """The constrained Poisson model; with ``cellfn=False`` the same
    model through the black-box likelihood ``torch_loglik`` alone."""
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model, POISSON)
    Y, C, W0, V0, ep = poisson_problem(0, n, m, T, k)
    cfg = dict(SCHEDULES[schedule])
    use_ep = cfg.pop("ep", False)
    model = Model(n, m, T, torch_loglik, C, device=device, nembeds=k,
                  tf_order=1, sigma2_init=0.5, lam2_init=0.1, W_init=W0,
                  V_init=V0, gass_ngrid=12, seed=seed, nchains=nchains,
                  loglikelihood_cellfn=POISSON if cellfn else None,
                  interweave=True,
                  factor_rebalance=True, mesh=mesh,
                  ep_approx=ep if use_ep else None, **cfg, **kw)
    return model, Y


def family_model(family, mesh=None, nchains=2, seed=3, device="cpu"):
    """Every other BTF model at a small shape, with its data."""
    import functionalmf_tpu_torch as fmf
    rng = np.random.default_rng(11)
    n, m, T, k = 6, 4, 12, 2
    W = rng.normal(0, 1, (n, k))
    V = np.cumsum(rng.normal(0, 0.3, (m, T, k)), axis=1)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    common = dict(nembeds=k, tf_order=1, nchains=nchains, seed=seed,
                  device=device, mesh=mesh)
    if family == "gaussian":
        Y = Mu + rng.normal(0, 0.3, Mu.shape)
        Y[0, 0, :3] = np.nan
        return fmf.GaussianBayesianTensorFiltering(n, m, T, **common), Y
    if family == "gaussian_row":
        Y = Mu + rng.normal(0, 0.3, Mu.shape)
        return fmf.GaussianBayesianTensorFiltering(
            n, m, T, nu2_mode="row", **common), Y
    if family == "gaussian_hetero":
        Y = Mu + rng.normal(0, 0.3, Mu.shape)
        return fmf.GaussianBayesianTensorFiltering(
            n, m, T, nu2_true=rng.uniform(0.05, 0.2, Mu.shape), **common), Y
    if family == "binomial":
        N = rng.integers(3, 9, Mu.shape).astype(float)
        Y = rng.binomial(N.astype(int), 1 / (1 + np.exp(-Mu))).astype(float)
        return fmf.BinomialBayesianTensorFiltering(n, m, T, **common), (Y, N)
    if family == "negbinom":
        Y = rng.poisson(np.exp(np.clip(Mu, -3, 3))).astype(float)
        return fmf.NegativeBinomialBayesianTensorFiltering(
            n, m, T, nmetropolis=5, **common), Y
    if family == "nonconjugate":
        Y = rng.poisson(np.exp(np.clip(Mu, -3, 3))).astype(float)

        return fmf.NonconjugateBayesianTensorFiltering(
            n, m, T, nonconj_loglik, ess_max_iters=30, **common), Y
    raise ValueError(family)


def nonconj_loglik(W, V, Y):
    rate = torch.exp(torch.clamp(torch.einsum("nk,mtk->nmt", W, V), -10, 10))
    return (Y * torch.log(rate) - rate).sum()


# ----------------------------------------------------------------------
# what a rank runs
# ----------------------------------------------------------------------
def rank_scenarios(rank, mesh_shape, scenarios):
    """Build the mesh, then run each (name, function name, kwargs) of
    ``scenarios`` on it; {name: result, or the traceback of its error}."""
    from functionalmf_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(*mesh_shape, device_type="cpu")
    out = {}
    for name, fn, kw in scenarios:
        try:
            out[name] = globals()[fn](mesh, **kw)
        except Exception:                                    # noqa: BLE001
            out[name] = "error:\n" + traceback.format_exc()
    return out


def run_constrained(mesh, schedule, nburn, nsamples, **kw):
    """A sharded run of the constrained model: the results dict (every
    rank gets the whole one), its worst constraint slack, this rank's part
    and its local shapes."""
    model, Y = constrained_model(schedule, mesh=mesh, **kw)
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    p = model._part
    return dict(res=res, slack=model._worst_constraint_slack(),
                part=(p.nc, p.nr, p.nm, p.split_c, p.split_r, p.split_m),
                local_W=tuple(model._state["W"].shape),
                local_V=tuple(model._state["V"].shape))


def run_family(mesh, family, nburn, nsamples):
    model, Y = family_model(family, mesh=mesh)
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    return dict(res=res, local_W=tuple(model._state["W"].shape),
                local_V=tuple(model._state["V"].shape),
                local_nu2=tuple(model._state["nu2"].shape)
                if "nu2" in model._state else None)


def round_trip(mesh, state, specs):
    """shard_state then gather_state of a global state dict: this rank's
    local shapes and the gathered state."""
    from functionalmf_tpu_torch.parallel.mesh import (
        gather_state, shard_state, state_specs)
    local = shard_state(state, mesh, specs)
    back = gather_state(local, mesh, state_specs(mesh, specs, state))
    return ({k: tuple(v.shape) for k, v in local.items()},
            {k: v.numpy() for k, v in back.items()})


def interop_round_trip(mesh, np_state):
    """A global numpy state through ``load_state`` onto the mesh and back
    through ``state_to_numpy(model.state)``; and ``state_from_numpy`` with
    the mesh against the model's own slices."""
    from functionalmf_tpu_torch.interop import (state_from_numpy,
                                                state_to_numpy)
    model, _ = constrained_model("redblack", mesh=mesh)
    model.load_state(np_state)
    local = state_from_numpy(np_state, "cpu", mesh,
                             model.state_partition_specs())
    same = all(torch.equal(local[k], model._state[k]) for k in local)
    return state_to_numpy(model.state), same, {
        k: tuple(v.shape) for k, v in model._state.items()}


def unsharded(fn_model, *args, nburn, nsamples, **kw):
    """The same run in this process, without a mesh, on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, Y = fn_model(*args, **kw)
        return model, model.run_gibbs(Y, nburn=nburn, nthin=1,
                                      nsamples=nsamples, verbose=False)
    finally:
        torch.set_num_threads(n)


def rank_jax_step(rank, state, v, w_noise, v_noise, cellfn=True):
    """One W update and one seq V update of the seq+EP model (with the
    cellfn, or through the black-box likelihood alone) on a (2, 2) mesh
    from the global ``state``, under injected global draws: the W
    proposal draws ``v`` (nch, n, k), the W update's (log u, Gumbel) and,
    a round at a time, the V blocks' normals and (log u, Gumbel). Returns
    the gathered W and V, and the branch each update took."""
    from functionalmf_tpu_torch.models import constrained as tc
    from functionalmf_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(2, 2, device_type="cpu")
    model, Y = constrained_model("seq_ep", mesh=mesh, cellfn=cellfn)
    model.load_state(state)
    p = model._part
    pdata = model.prepare_data(Y)
    t = torch.as_tensor
    tc.sample_mvn_from_precision = lambda *a, **kw: t(v)[p.c, p.r]
    tc.draw_gass_noise = lambda *a: (t(w_noise[0]), t(w_noise[1]))
    W = model._update_W_gass(model._state, pdata, None)["W"]
    zs = iter([t(z) for z, _, _ in v_noise])
    lug = iter([(t(lu), t(g)) for _, lu, g in v_noise])
    real_randn = tc.torch.randn
    tc.torch.randn = lambda *a, **kw: next(zs)
    tc.draw_gass_noise = lambda *a: next(lug)
    try:
        V = model._update_V_gass(model._state, pdata, None)["V"]
    finally:
        tc.torch.randn = real_randn
    out = model._gather({"W": W, "V": V}, model._specs)
    out = {k: x.numpy() for k, x in out.items()}
    out["split"] = dict(model._data_split)
    return out


# ----------------------------------------------------------------------
# the black-box likelihood models (no cellfn) and their data pytrees
# ----------------------------------------------------------------------
def _poisson_ll(Y, WV):
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    Y0 = torch.where(nan, 0.0, Y)
    return torch.where(nan, 0.0, Y0 * torch.log(rate) - rate).sum()


def _cross_entropy(x, WU):
    WU = torch.clamp(WU, 1e-6, 1 - 1e-6)
    return (x * torch.log(WU) + (1 - x) * torch.log(1 - WU)).sum()


def bb_loglik(data, WV, W, V, row=None, col=None):
    """Poisson counts ``data["Y"]`` and, where the pytree holds them,
    binary row features ``data["X"]`` (n, p) with embeddings
    ``data["U"]`` (p, k): the dose-response app's likelihood in form."""
    Y = data["Y"]
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    ll = _poisson_ll(Y, WV)
    if "X" in data and col is None:
        U = data["U"]
        if row is not None:
            ll = ll + _cross_entropy(data["X"][row], U @ W)
        else:
            ll = ll + _cross_entropy(data["X"], W @ U.T)
    return ll


def bb_cells(data, WV, W, Vb, col=None, t0=None, size=None):
    return _poisson_ll(data["Y"][:, col][:, t0 + torch.arange(size)], WV)


def bb_block(data, WV, W, Vb, row=None, col=None, tslice=None):
    return _poisson_ll(data["Y"][:, col][:, tslice[0]:tslice[1]], WV)


# the black-box variants: the V update's form of the likelihood and the
# model's options
BLACKBOX = {
    "seq": dict(v_schedule="seq", v_block_size=4),
    "redblack_cells": dict(v_schedule="redblack", v_block_size=2,
                           loglikelihood_cells=bb_cells),
    "block": dict(v_schedule="seq", v_block_size=4,
                  loglikelihood_block=bb_block),
    "ep": dict(v_schedule="seq", v_block_size=4, ep=True),
    "row_constraints": dict(v_schedule="seq", v_block_size=None, rc=True),
}


def blackbox_data(features, n=8, m=8, T=6, k=2, p=4):
    """The data pytree {Y} (every leaf row- and column-indexed: the slab
    branch) or {Y, X, U} with p features (X (n, p) and U (p, k) are not
    column-indexed and U is not row-indexed: the whole branch)."""
    Y, C, W0, V0, ep = poisson_problem(0, n, m, T, k)
    data = {"Y": Y}
    if features:
        rng = np.random.default_rng(2)
        data["X"] = (rng.random((n, p)) < 0.5).astype(np.float64)
        data["U"] = rng.uniform(0.02, 0.2, (p, k))
    return data, C, W0, V0, ep


def blackbox_model(variant, features, mesh=None, nchains=2, seed=5,
                   loglik=bb_loglik, n=8, m=8, T=6, k=2):
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.apps.doseresponse.fit import (
        row_constraints_of)
    data, C, W0, V0, ep = blackbox_data(features, n, m, T, k)
    cfg = dict(BLACKBOX[variant])
    use_ep, rc = cfg.pop("ep", False), cfg.pop("rc", False)
    U = data.get("U", np.random.default_rng(2).uniform(0.02, 0.2, (4, k)))
    model = Model(n, m, T, loglik, C, device="cpu", nembeds=k, tf_order=1,
                  sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
                  gass_ngrid=12, seed=seed, nchains=nchains, mesh=mesh,
                  ep_approx=ep if use_ep else None,
                  Row_constraints=row_constraints_of(U) if rc else None,
                  **cfg)
    return model, data


def run_blackbox(mesh, variant, features, nburn, nsamples):
    """A sharded run of the black-box model: the results, the branch each
    update took and the worst constraint slack."""
    model, data = blackbox_model(variant, features, mesh=mesh)
    res = model.run_gibbs(data, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    return dict(res=_arrays(res), split=dict(model._data_split),
                slack=model._worst_constraint_slack())


def _arrays(res):
    return {k: v for k, v in res.items() if isinstance(v, np.ndarray)}


def index_loglik(data, WV, W, V, row=None, col=None):
    """Returns the index it was given (row, else col), so that the lifted
    call's output records the indices the user's function received."""
    idx = row if row is not None else col
    return idx.to(WV.dtype) + 0.0 * WV.sum()


def index_cells(data, WV, W, Vb, col=None, t0=None, size=None):
    return col.to(WV.dtype) + 0.0 * WV.sum()


def rank_indices(mesh, features):
    """The row indices the W update's lifted call hands the user's
    function and the column indices of a red-black V round's, on this
    rank's items (chain 0), with the branch each update took."""
    model, data = blackbox_model("redblack_cells", features, mesh=mesh,
                                 loglik=index_loglik)
    model.loglikelihood_cells = index_cells
    pdata = model.prepare_data(data)
    p, k, G = model._part, model.nembeds, 3
    V = p.all_cols(model._state["V"])
    W = (p.all_rows(model._state["W"]) * model._wmask).contiguous()
    dmask = model._wmask_rows.expand(p.nc, p.nr, k).reshape(-1, k)
    cands = torch.ones((p.nc * p.nr, G, k))
    rows = model._w_loglik_blackbox(pdata, V, dmask)(cands)
    ph = model._phases[0]
    nblk = len(ph.starts)
    X = model._state["V"]
    vc = torch.ones((p.nc * p.nm * nblk, G, ph.size * k))
    cols = model._v_loglik_blackbox(pdata, W, X, ph)(vc)
    return dict(split=dict(model._data_split),
                rows=rows.reshape(p.nc, p.nr, G)[0, :, 0].numpy(),
                cols=cols.reshape(p.nc, p.nm, nblk, G)[0, :, 0, 0].numpy(),
                r=(p.r.start, p.r.stop), m=(p.m.start, p.m.stop))


# ----------------------------------------------------------------------
# NonconjugateBayesianTensorFiltering (ESS) at 6x4x8
# ----------------------------------------------------------------------
def nonconj_model(mesh=None, nchains=2, seed=3, n=6, m=4, T=8, k=2):
    import functionalmf_tpu_torch as fmf
    rng = np.random.default_rng(11)
    W = rng.normal(0, 1, (n, k))
    V = np.cumsum(rng.normal(0, 0.3, (m, T, k)), axis=1)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(np.exp(np.clip(Mu, -3, 3))).astype(float)
    Y[0, 1, :3] = np.nan
    model = fmf.NonconjugateBayesianTensorFiltering(
        n, m, T, nonconj_nan_loglik, ess_max_iters=30, nembeds=k,
        tf_order=1, nchains=nchains, seed=seed, device="cpu", mesh=mesh)
    return model, Y


def nonconj_nan_loglik(W, V, Y):
    eta = torch.clamp(torch.einsum("nk,mtk->nmt", W, V), -10, 10)
    nan = torch.isnan(Y)
    return torch.where(nan, 0.0, torch.where(nan, 0.0, Y) * eta
                       - torch.exp(eta)).sum()


DIC_GRID = dict(lam2=[0.5, 0.05], nburn=2, nsamples=2)


def run_nonconj(mesh, nburn, nsamples, dic=False):
    """A sharded ESS run: its results, the logprob of its last draw and,
    with ``dic``, the DIC grid search's scores on a fresh model."""
    model, Y = nonconj_model(mesh=mesh)
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    p = model._part
    out = dict(res=_arrays(res),
               logprob=model.logprob(Y, W=res["W"][-1], V=res["V"][-1]),
               local=(tuple(model._state["W"].shape),
                      tuple(model._state["V"].shape)),
               split=(p.split_c, p.split_r, p.split_m))
    if dic:
        fresh, _ = nonconj_model(mesh=mesh)
        out["dic"] = fresh.select_hyperparams_DIC(Y, verbose=False,
                                                  **DIC_GRID)["scores"]
    return out


# ----------------------------------------------------------------------
# the driver's options under a mesh, on the {Y, X, U} black-box model
# with Row_constraints
# ----------------------------------------------------------------------
HOOK_RUN = dict(nburn=2, nthin=1, nsamples=4)


def rc_u_hook(state, pdata, gen, step):
    """A device-side hook that rescales the feature embeddings U in the
    data by a drawn factor and rewrites every chain's Row_constraints
    offsets just below what its current W attains (so that they hold
    and bind in the next sweep)."""
    W, RC = state["W"], state["Row_constraints"].clone()
    k = W.shape[-1]
    u = torch.rand((), generator=gen)
    vals = torch.einsum("cnk,cjk->cnj", W, RC[:, :, :k]).amin(1)
    RC[:, :, k] = vals - 0.01 - 0.1 * torch.rand(vals.shape, generator=gen)
    return (dict(state, Row_constraints=RC),
            dict(pdata, U=pdata["U"] * (0.9 + 0.2 * u)))


def rc_u_callback(model, data, step):
    """The host flavour of ``rc_u_hook``: it rewrites ``data["U"]`` and
    marks the data dirty, reads W and Row_constraints through the model's
    properties and sets the new rows."""
    rng = np.random.default_rng(step)
    data["U"] = data["U"] * (0.9 + 0.2 * rng.random())
    model.mark_data_dirty()
    W, RC = model.W, model.Row_constraints.copy()
    k = W.shape[-1]
    vals = np.einsum("cnk,cjk->cnj", W, RC[:, :, :k]).min(1)
    RC[:, :, k] = vals - 0.01 - 0.1 * rng.random(vals.shape)
    model.Row_constraints = RC


def hooked_model(mesh=None):
    return blackbox_model("row_constraints", True, mesh=mesh)


def hooked_run(mesh=None, checkpoint=None, nsamples=HOOK_RUN["nsamples"],
               resume=False, host=False):
    """The hooked run (device hook, or the host callback with ``host``),
    collecting U and Row_constraints; with ``checkpoint`` it writes (and,
    with ``resume``, continues from) that file."""
    model, data = hooked_model(mesh)
    kw = dict(HOOK_RUN, nsamples=nsamples, verbose=False,
              collect_data_keys=("U", "Row_constraints"))
    if host:
        kw["callback"] = rc_u_callback
    else:
        kw["traced_callback"] = rc_u_hook
    if checkpoint:
        kw.update(checkpoint_path=checkpoint, resume=resume)
    res = model.run_gibbs(data, **kw)
    return dict(res=_arrays(res), split=dict(model._data_split),
                slack=model._worst_constraint_slack())


def run_resumed(mesh, ck_dir):
    """On the mesh: the whole hooked run; the run cut after its first
    draw (3 sweeps) and resumed from its own checkpoint; and the resume of
    the checkpoint ``unsharded.npz`` that an unsharded run wrote. The cut
    run leaves ``mesh.npz`` for an unsharded resume."""
    whole = hooked_run(mesh)
    ck = os.path.join(ck_dir, "mesh.npz")
    hooked_run(mesh, checkpoint=ck, nsamples=1)
    cut = os.path.join(ck_dir, "cut.npz")
    hooked_run(mesh, checkpoint=cut, nsamples=1)
    resumed = hooked_run(mesh, checkpoint=cut, resume=True)
    from_unsharded = hooked_run(mesh, resume=True, checkpoint=os.path.join(
        ck_dir, "unsharded.npz"))
    return dict(whole=whole, resumed=resumed, from_unsharded=from_unsharded)


def run_profiled(mesh, profile_dir):
    model, data = hooked_model(mesh)
    model.run_gibbs(data, nburn=0, nthin=1, nsamples=1, verbose=False,
                    profile_dir=profile_dir, traced_callback=rc_u_hook)
    return sorted(os.listdir(profile_dir))
