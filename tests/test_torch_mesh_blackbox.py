"""The constrained model without a cell function (a black-box likelihood)
at mp > 1, on spawned ``gloo`` ranks (tests/torch_mesh_ranks.py) against
the unsharded run in this process.

Meshes (dp=1, mp=2) and (dp=2, mp=2), at 8x8x6, k=2, nchains=2, ngrid 12,
positivity, 1 + 1 sweeps with interweave and factor_rebalance on, for the
V update's every form: whole curves (seq), ``loglikelihood_cells``
(red-black), ``loglikelihood_block`` (seq), EP (seq) and
``Row_constraints`` (joint). Each on two data pytrees:

* ``{Y}``: every leaf is indexed by row and by column, so each rank holds
  its row slab and its column slab, and the user's function gets
  positions in the slab ("slab", as in the JAX package's ``shard_map``
  regions);
* ``{Y, X, U}`` with p=4 features: X (n, p) is not column-indexed and
  U (p, k) not row-indexed, so every rank reads the whole pytree at
  global indices ("whole", as in the JAX package's regions without
  ``shard_map``). The JAX package cuts U over its p rows here and fails
  (ROADMAP.md, "Known faults of the reference").

Tolerance: rtol = atol = 1e-5 on W, V, sigma2, lam2 and Tau2. The mp
sums run in two stages whose partial sums are the unsharded run's
(models/base.py:_Part._sum), so the runs agree to rounding; every rank
returns the same results dict."""
import numpy as np
import pytest

from tests.torch_mesh_ranks import (BLACKBOX, blackbox_model,
                                    rank_scenarios, spawn_ranks, unsharded)

MESHES = ((1, 2), (2, 2))
DATA = {"slab": False, "whole": True}     # the {Y, X, U} pytree or not
SWEEPS = dict(nburn=1, nsamples=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scen = [(f"{v}-{d}", "run_blackbox", dict(variant=v, features=f,
                                             **SWEEPS))
            for v in BLACKBOX for d, f in DATA.items()]
    scen += [(f"indices-{d}", "rank_indices", dict(features=f))
             for d, f in DATA.items()]
    return {shape: spawn_ranks(rank_scenarios, shape[0] * shape[1],
                               tmp_path_factory.mktemp("rdv"), shape, scen)
            for shape in MESHES}


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(variant, data):
        if (variant, data) not in cache:
            model, _ = blackbox_model(variant, DATA[data])
            start = (model.W, model.V)
            cache[variant, data] = start, unsharded(
                blackbox_model, variant, DATA[data], **SWEEPS)[1]
        return cache[variant, data]
    return get


def _ok(outs, name):
    for r, o in enumerate(outs):
        assert not isinstance(o[name], str), f"rank {r}: {o[name]}"
    return [o[name] for o in outs]


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("variant", BLACKBOX)
@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
def test_blackbox_sharded_run_equals_unsharded(runs, refs, shape, variant,
                                               data):
    got = _ok(runs[shape], f"{variant}-{data}")
    (W0, V0), ref = refs(variant, data)
    for r, o in enumerate(got):
        assert o["split"] == {"W": data, "V": data}, r
        assert o["slack"] >= -1e-5, r
        for key in ("W", "V", "sigma2", "lam2", "Tau2"):
            np.testing.assert_array_equal(o["res"][key], got[0]["res"][key],
                                          err_msg=f"rank {r} {key}")
    for key in ("W", "V", "sigma2", "lam2", "Tau2"):
        np.testing.assert_allclose(got[0]["res"][key], ref[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    # the draws moved
    assert not np.allclose(got[0]["res"]["W"][0], W0[0])
    assert not np.allclose(got[0]["res"]["V"][0], V0[0])


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
def test_user_function_gets_slab_positions_or_global_indices(runs, shape,
                                                             data):
    """A likelihood that returns the index it gets: on the slab each rank's
    rows and columns are 0..3, on the whole pytree they are the rank's
    global rows and columns (4..7 on the second rank of an mp line)."""
    got = _ok(runs[shape], f"indices-{data}")
    seen = set()
    for o in got:
        assert o["split"] == {"W": data, "V": data}
        r0, m0 = (0, 0) if data == "slab" else (o["r"][0], o["m"][0])
        np.testing.assert_array_equal(o["rows"], r0 + np.arange(4))
        np.testing.assert_array_equal(o["cols"], m0 + np.arange(4))
        seen.add(o["r"])
    assert seen == {(0, 4), (4, 8)}
