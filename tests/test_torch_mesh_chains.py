"""Chains over dp for every BTF model: a (dp=2, mp=1) mesh of two spawned
``gloo`` ranks (tests/torch_mesh_ranks.py), one chain a rank, against the
unsharded two-chain run in this process, 2 + 2 sweeps.

What holds: on the CPU the draws are equal bit for bit, for the
constrained model (red-black, seq+EP, joint) and for the Gaussian
(scalar and per-row nu2), Binomial, NegBinom and nonconjugate models.
Every draw is taken for both chains on both ranks and each rank keeps
its chain; a chain's arithmetic does not depend on how many chains a
rank holds (its sums run over contiguous axes: ``_deltas`` and the
Polya-Gamma series are laid out so)."""
import numpy as np
import pytest

from tests.torch_mesh_ranks import (constrained_model, family_model,
                                    rank_scenarios, spawn_ranks, unsharded)

FAMILIES = ("gaussian", "gaussian_row", "binomial", "negbinom",
            "nonconjugate")
SCHEDS = ("redblack", "seq_ep", "joint")
SWEEPS = dict(nburn=2, nsamples=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scen = [(f, "run_family", dict(family=f, **SWEEPS)) for f in FAMILIES]
    scen += [(s, "run_constrained", dict(schedule=s, **SWEEPS))
             for s in SCHEDS]
    return spawn_ranks(rank_scenarios, 2, tmp_path_factory.mktemp("rdv"),
                       (2, 1), scen)


def _check(outs, name, ref):
    for r, o in enumerate(outs):
        assert not isinstance(o[name], str), f"rank {r}: {o[name]}"
        assert o[name]["local_W"][0] == 1          # one chain a rank
    got = outs[0][name]["res"]
    assert set(got) == set(ref)
    for key, want in ref.items():
        if key == "rhat":
            assert got[key] == want
            continue
        for o in outs[1:]:
            np.testing.assert_array_equal(o[name]["res"][key], got[key])
        np.testing.assert_array_equal(got[key], want, err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_chains_over_dp_equal_the_unsharded_run(runs, family):
    _, ref = unsharded(family_model, family, **SWEEPS)
    _check(runs, family, ref)


@pytest.mark.parametrize("schedule", SCHEDS)
def test_constrained_chains_over_dp_equal_the_unsharded_run(runs,
                                                            schedule):
    _, ref = unsharded(constrained_model, schedule, **SWEEPS)
    _check(runs, schedule, ref)
