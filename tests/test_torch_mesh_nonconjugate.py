"""``NonconjugateBayesianTensorFiltering`` (ESS) at mp > 1, on spawned
``gloo`` ranks (tests/torch_mesh_ranks.py) against the unsharded run in
this process: 6x4x8, k=2, nchains=2, a Poisson log-link likelihood with a
missing stretch, 2 + 2 sweeps, on (dp=1, mp=2) and (dp=2, mp=2).

W's rows and V's columns are split over mp (each rank holds 3 rows and 2
columns); an update gathers them, runs one joint ESS step over the
global arrays on every rank with the same noise and keeps the rank's
slice. ``logprob`` of a draw and ``select_hyperparams_DIC``'s scores (a
grid of two lam2 values, 2 + 2 sweeps each) run on the mesh model too.
Tolerance: rtol = atol = 1e-6."""
import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import (DIC_GRID, nonconj_model, rank_scenarios,
                                    spawn_ranks, unsharded)

MESHES = ((1, 2), (2, 2))
SWEEPS = dict(nburn=2, nsamples=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scen = [("ess", "run_nonconj", dict(dic=True, **SWEEPS))]
    return {shape: spawn_ranks(rank_scenarios, shape[0] * shape[1],
                               tmp_path_factory.mktemp("rdv"), shape,
                               scen)
            for shape in MESHES}


@pytest.fixture(scope="module")
def ref():
    model, res = unsharded(nonconj_model, **SWEEPS)
    _, Y = nonconj_model()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fresh, _ = nonconj_model()
        dic = fresh.select_hyperparams_DIC(Y, verbose=False,
                                           **DIC_GRID)["scores"]
    finally:
        torch.set_num_threads(n)
    return dict(res=res, dic=dic, start=(model.W, model.V),
                logprob=model.logprob(Y, W=res["W"][-1], V=res["V"][-1]))


def _ok(outs):
    for r, o in enumerate(outs):
        assert not isinstance(o["ess"], str), f"rank {r}: {o['ess']}"
    return [o["ess"] for o in outs]


@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
def test_nonconjugate_mp_run_equals_unsharded(runs, ref, shape):
    got = _ok(runs[shape])
    nc = 2 // shape[0]
    for r, o in enumerate(got):
        assert o["local"] == ((nc, 3, 2), (nc, 2, 8, 2)), r
        assert o["split"] == (shape[0] > 1, True, True), r
        for key, v in o["res"].items():
            np.testing.assert_array_equal(v, got[0]["res"][key],
                                          err_msg=f"rank {r} {key}")
    assert set(got[0]["res"]) == set(ref["res"]) - {"rhat"}
    for key in ("W", "V", "sigma2", "lam2", "Tau2", "nan_fallbacks"):
        np.testing.assert_allclose(got[0]["res"][key], ref["res"][key],
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    W0, V0 = ref["start"]
    assert not np.allclose(got[0]["res"]["W"][0], W0[0])
    assert not np.allclose(got[0]["res"]["V"][0], V0[0])


@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
def test_nonconjugate_logprob_and_dic_on_a_mesh(runs, ref, shape):
    for o in _ok(runs[shape]):
        np.testing.assert_allclose(o["logprob"], ref["logprob"], rtol=1e-6)
        np.testing.assert_allclose(o["dic"], ref["dic"], rtol=1e-6)
