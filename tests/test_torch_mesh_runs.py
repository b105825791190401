"""Sharded runs of the port on spawned ``gloo`` ranks (CPU), held to the
unsharded run in this process.

One group of 4 ranks, a (dp=2, mp=2) mesh, runs every scenario of this
file (tests/torch_mesh_ranks.py): the shard/gather round trip, the
constrained model at JAX's test shape (8x8x6, k=2, nchains=2, ngrid 12,
tf_order 1, positivity; tests/test_parallel.py:87-138) for 1 + 1 sweeps
with interweave and factor_rebalance on under the red-black, seq+EP and
joint schedules, the same with 9 rows (indivisible by mp=2: W stays
whole on every rank, as JAX replicates it), a longer run, the recipe at
nchains 4 for chip_smoke.py's c4 length (2 + 4 sweeps), and the
Gaussian (scalar, per-row and fixed heteroskedastic nu2), Binomial and
NegBinom models at 6x4x12, k=2, nchains=2, for 1 + 1 and for 3 + 3
sweeps.

Tolerance. A sharded run draws what the unsharded run draws, and its
sums over rows and columns, and every sum found to round by the number
of chains, rows or columns a rank holds, run in a fixed order
(``models/base.py:_Part._sum``, ``_fixed_sum``; the families' W and V
updates in ``models/gaussian.py``, NegBinom's R moves in ``_window_sum``):
the constrained runs and the family runs equal the unsharded run bit for
bit (on the card too: chip_smoke.py phase (b)). The 1 + 1 sweep runs of
the three schedules and of 9 rows are held to rtol = atol = 1e-3, JAX's
own bound for its sharded run. The rank-free tests at the end hold each
fixed-order site of the family updates: a rank's block of the call
equals the same block of the whole call.
Every rank returns the same results dict."""
import numpy as np
import pytest

import torch

from functionalmf_tpu_torch.models.base import _window_sum
from functionalmf_tpu_torch.models.gaussian import (cell_means, v_mean_part,
                                                     w_likelihood_terms)
from tests.torch_mesh_ranks import (constrained_model, family_model,
                                    rank_scenarios, spawn_ranks, unsharded)

SCHEDS = ("redblack", "seq_ep", "joint")
FAMILIES = ("gaussian", "gaussian_row", "gaussian_hetero", "binomial",
            "negbinom")
LONG = dict(nburn=25, nsamples=15)
FAMILY_LONG = dict(nburn=3, nsamples=3)
# chip_smoke.py's c4: the recipe (red-black, interweave, factor_rebalance)
# at nchains 4, 2 + 4 sweeps, here at 8x8x12
C4 = dict(nburn=2, nsamples=4, nchains=4, T=12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    state = {"W": rng.normal(size=(2, 9, 2)).astype(np.float32),
             "V": rng.normal(size=(2, 8, 6, 2)).astype(np.float32),
             "sigma2": rng.normal(size=(2,)).astype(np.float32)}
    specs = {"W": ("dp", "mp"), "V": ("dp", "mp"), "sigma2": ("dp",)}
    scen = [("round_trip", "round_trip", dict(state=state, specs=specs))]
    scen += [(s, "run_constrained", dict(schedule=s, nburn=1, nsamples=1))
             for s in SCHEDS]
    scen += [("rows9", "run_constrained",
              dict(schedule="redblack", nburn=1, nsamples=1, n=9))]
    scen += [("long", "run_constrained", dict(schedule="redblack", **LONG))]
    scen += [("c4", "run_constrained", dict(schedule="redblack", **C4))]
    scen += [("interop", "interop_round_trip", dict(np_state=_np_state()))]
    scen += [(f, "run_family", dict(family=f, nburn=1, nsamples=1))
             for f in FAMILIES]
    scen += [(f"{f}_long", "run_family", dict(family=f, **FAMILY_LONG))
             for f in FAMILIES]
    outs = spawn_ranks(rank_scenarios, 4, tmp_path_factory.mktemp("rdv"),
                       (2, 2), scen)
    return state, outs


def _np_state():
    """A global numpy state of the redblack model (as the JAX package's
    ``{k: np.asarray(v)}`` would be), every entry moved off its start."""
    model, _ = constrained_model("redblack")
    return {k: v.numpy() * 1.5 + 0.25 for k, v in model.state.items()}


def _ok(outs, name):
    for r, o in enumerate(outs):
        assert not isinstance(o[name], str), f"rank {r}: {o[name]}"
    return [o[name] for o in outs]


def test_shard_then_gather_gives_the_global_state_back(runs):
    state, outs = runs
    for r, (shapes, back) in enumerate(_ok(outs, "round_trip")):
        # 9 rows do not divide over mp=2: W keeps every row
        assert shapes == {"W": (1, 9, 2), "V": (1, 4, 6, 2),
                          "sigma2": (1,)}, r
        for k, v in state.items():
            np.testing.assert_array_equal(back[k], v)


def test_interop_carries_a_global_state_onto_the_mesh_and_back(runs):
    want = _np_state()
    for r, (back, same, shapes) in enumerate(_ok(runs[1], "interop")):
        assert same, r
        assert shapes["W"] == (1, 4, 2) and shapes["Tau2"][:2] == (1, 4)
        for k, v in want.items():
            np.testing.assert_array_equal(back[k], v.astype(np.float32))


@pytest.mark.parametrize("schedule", SCHEDS)
def test_sharded_run_equals_unsharded(runs, schedule):
    _, outs = runs
    got = _ok(outs, schedule)
    _, ref = unsharded(constrained_model, schedule, nburn=1, nsamples=1)
    assert got[0]["part"] == (1, 4, 4, True, True, True)
    assert got[0]["local_W"] == (1, 4, 2)
    assert got[0]["local_V"] == (1, 4, 6, 2)
    for key in ("W", "V", "sigma2", "lam2", "Tau2"):
        for r, o in enumerate(got):
            np.testing.assert_array_equal(o["res"][key], got[0]["res"][key],
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_allclose(got[0]["res"][key], ref[key], rtol=1e-3,
                                   atol=1e-3, err_msg=key)
    model, _ = constrained_model(schedule)
    assert not np.allclose(got[0]["res"]["V"], model.V)
    assert got[0]["slack"] >= -1e-5


def _family_equal(runs, family, name, **sweeps):
    got = _ok(runs[1], name)
    model, ref = unsharded(family_model, family, **sweeps)
    assert got[0]["local_W"] == (1, 3, 2) and got[0]["local_V"][:2] == (1, 2)
    if family != "gaussian":
        assert got[0]["local_nu2"][:2] == (1, 3)     # nu2 has W's rows
    for key, want in ref.items():
        if key == "rhat":
            continue
        for r, o in enumerate(got):
            np.testing.assert_array_equal(o["res"][key], want,
                                          err_msg=f"rank {r} {key}")
    return model, ref


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_family_run_equals_unsharded(runs, family):
    """W rows and V columns over mp: the W update row-local, the banded V
    update column-local, the nu2 / PG draw and the R moves on the whole
    tensor on every rank; every rank's draws equal the unsharded run's
    bit for bit after 1 + 1 sweeps."""
    _family_equal(runs, family, family, nburn=1, nsamples=1)


@pytest.mark.parametrize("family", FAMILIES)
def test_longer_sharded_family_run_equals_unsharded(runs, family):
    """The same after 3 + 3 sweeps, where a last-bit difference of one
    sweep would have grown into the draws that follow it; the draws
    move."""
    model, ref = _family_equal(runs, family, f"{family}_long", **FAMILY_LONG)
    S = FAMILY_LONG["nsamples"]
    assert np.unique(ref["W"][:S], axis=0).shape[0] == S
    assert not np.allclose(ref["V"][-1], ref["V"][S - 1])


def test_indivisible_rows_stay_whole_and_agree(runs):
    """9 rows over mp=2: W is replicated (each rank holds all 9), V is
    split by columns, and the run still equals the unsharded one."""
    _, outs = runs
    got = _ok(outs, "rows9")
    _, ref = unsharded(constrained_model, "redblack", nburn=1, nsamples=1,
                       n=9)
    assert got[0]["part"] == (1, 9, 4, True, False, True)
    assert got[0]["local_W"] == (1, 9, 2)
    for key in ("W", "V", "sigma2", "lam2"):
        np.testing.assert_allclose(got[0]["res"][key], ref[key], rtol=1e-3,
                                   atol=1e-3, err_msg=key)


def test_longer_run_under_the_mesh(runs):
    """JAX's test_constrained_long_run_under_mesh (tests/test_parallel.py:
    142) at 25 + 15 sweeps: every draw feasible, the draws move, no
    non-finite fallback; and every draw equal to the unsharded run's bit
    for bit."""
    model, _ = constrained_model("redblack")
    W0, V0 = model.W, model.V
    got = _ok(runs[1], "long")
    res = got[0]["res"]
    S = LONG["nsamples"]
    assert res["W"].shape == (2 * S, 8, 2)
    assert np.isfinite(res["W"]).all() and np.isfinite(res["V"]).all()
    tau = np.einsum("snk,smtk->snmt", res["W"], res["V"])
    assert tau.min() >= -1e-5
    assert got[0]["slack"] >= -1e-5
    assert (res["nan_fallbacks"] == 0).all()
    # the draws move: away from the start and from one another
    assert not np.allclose(res["W"][:S], W0[0])
    assert not np.allclose(res["V"][S:], V0[1])
    assert np.unique(res["sigma2"]).size > S
    _, ref = unsharded(constrained_model, "redblack", **LONG)
    for key in ("W", "V", "sigma2", "lam2", "Tau2"):
        np.testing.assert_array_equal(res[key], ref[key], err_msg=key)


def test_recipe_at_the_smoke_runs_length_equals_the_unsharded_run(runs):
    """The recipe at nchains 4 for c4's 2 + 4 sweeps (chip_smoke.py phase
    (c)) on the (2, 2) mesh: every rank's draws equal the unsharded run's
    bit for bit, not merely within 1e-3."""
    got = _ok(runs[1], "c4")
    _, ref = unsharded(constrained_model, "redblack", **C4)
    assert got[0]["part"] == (2, 4, 4, True, True, True)
    for key in ("W", "V", "sigma2", "lam2", "Tau2"):
        for r, o in enumerate(got):
            np.testing.assert_array_equal(o["res"][key], ref[key],
                                          err_msg=f"rank {r} {key}")
    model, _ = constrained_model("redblack", **{k: C4[k] for k in
                                                ("nchains", "T")})
    assert not np.allclose(got[0]["res"]["V"][-1], model.V[-1])
    assert got[0]["slack"] >= -1e-5


# ----------------------------------------------------------------------
# the family updates' fixed-order sums, rank-free: a (2, 2) rank's block
# at the mesh tests' family shape (nchains 2, 6x4x12, k=2)
# ----------------------------------------------------------------------
def _family_terms(seed):
    g = torch.Generator().manual_seed(seed)
    nch, n, m, T, k = 2, 6, 4, 12, 2
    w8 = torch.randn((nch, n, m, T), generator=g) ** 2
    wy = torch.randn((nch, n, m, T), generator=g)
    return w8, wy, torch.randn((nch, n, k), generator=g), \
        torch.randn((nch, m, T, k), generator=g)


@pytest.mark.parametrize("seed", range(3))
def test_w_update_sums_of_a_ranks_rows_equal_the_whole_calls(seed):
    """The W update's Gram and mean part of a rank's chain and 3 of 6 rows
    equal the same rows of the call over every chain and row (a batched
    product ``wy @ V`` differs here in the last bits, on the CPU and on
    the card)."""
    w8, wy, _, V = _family_terms(seed)
    nch, n = w8.shape[:2]
    Vf = V.reshape(nch, -1, V.shape[-1])
    whole = w_likelihood_terms(w8.reshape(nch, n, -1),
                               wy.reshape(nch, n, -1), Vf)
    part = w_likelihood_terms(w8[:1, :3].reshape(1, 3, -1),
                              wy[:1, :3].reshape(1, 3, -1), Vf[:1])
    for a, b in zip(whole, part):
        assert torch.equal(a[:1, :3], b)
    torch.testing.assert_close(whole[1], wy.reshape(nch, n, -1) @ Vf,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_v_update_mean_part_of_a_ranks_columns_equals_the_whole_calls(seed):
    """The V update's mean part of a rank's chain and 2 of 4 columns
    equals the same columns of the call over every chain and column (the
    einsum differs here in the last bits on the CPU)."""
    _, wy, W, _ = _family_terms(seed)
    whole = v_mean_part(wy, W)
    assert torch.equal(whole[:1, :2],
                       v_mean_part(wy[:1, :, :2].contiguous(), W[:1]))
    torch.testing.assert_close(whole, torch.einsum("cijt,cia->cjta", wy, W),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_cell_means_and_r_sums_of_a_ranks_chain_equal_the_whole_calls(seed):
    """W V^T of a rank's chain (the nu2 and PG draws and the R moves; the
    einsum differs here on the card) and the R moves' sum of a chain's
    cells (a reduction over chains differs on the card at 20x20x228)
    equal the same chain of the call over both chains."""
    _, wy, W, V = _family_terms(seed)
    whole = cell_means(W, V)
    assert torch.equal(whole[:1], cell_means(W[:1], V[:1]))
    torch.testing.assert_close(whole, torch.einsum("cnk,cmtk->cnmt", W, V),
                               rtol=1e-5, atol=1e-5)
    al = wy[..., None] * 10                  # (nchains, n, m, T, replicates)
    agg = (1, 2, 3, 4)
    whole = _window_sum(al, agg)
    assert torch.equal(whole[:1], _window_sum(al[:1].contiguous(), agg))
    torch.testing.assert_close(whole, al.sum(agg, keepdim=True), rtol=1e-5,
                               atol=1e-4)
