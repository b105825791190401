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
NegBinom models at 6x4x12, k=2, nchains=2.

Tolerance. A sharded run draws what the unsharded run draws, and its
sums over rows and columns run in a fixed order
(``models/base.py:_Part._sum``): after 1 + 1 sweeps W, V, sigma2 and lam2
(and nu2 and R) agree within rtol = atol = 1e-3, JAX's own bound for its
sharded run (measured here: the constrained runs to the bit; the
Gaussian, Binomial and NegBinom runs not to the bit, the step not traced
on the CPU; on the card the Gaussian run is equal to the bit,
chip_smoke.py phase (b)).
Every rank returns the same results dict."""
import numpy as np
import pytest

from tests.torch_mesh_ranks import (constrained_model, family_model,
                                    rank_scenarios, spawn_ranks, unsharded)

SCHEDS = ("redblack", "seq_ep", "joint")
FAMILIES = ("gaussian", "gaussian_row", "gaussian_hetero", "binomial",
            "negbinom")
LONG = dict(nburn=25, nsamples=15)
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


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_family_run_equals_unsharded(runs, family):
    """W rows and V columns over mp: the W update row-local, the banded V
    update column-local, the nu2 / PG draw and the R moves on the whole
    tensor on every rank."""
    got = _ok(runs[1], family)
    _, ref = unsharded(family_model, family, nburn=1, nsamples=1)
    assert got[0]["local_W"] == (1, 3, 2) and got[0]["local_V"][:2] == (1, 2)
    if family != "gaussian":
        assert got[0]["local_nu2"][:2] == (1, 3)     # nu2 has W's rows
    for key, want in ref.items():
        if key == "rhat":
            continue
        for r, o in enumerate(got):
            np.testing.assert_array_equal(o["res"][key], got[0]["res"][key],
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_allclose(got[0]["res"][key], want, rtol=1e-3,
                                   atol=1e-3, err_msg=key)


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
