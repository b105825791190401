"""``run_gibbs``'s options under a (dp=2, mp=2) mesh of four spawned
``gloo`` ranks (tests/torch_mesh_ranks.py), each against the unsharded
run in this process: the black-box constrained model at 8x8x6, k=2,
nchains=2, on the {Y, X, U} pytree (p=4 features) with Row_constraints,
2 + 4 sweeps.

* ``traced_callback`` with ``collect_data_keys``: the hook rescales U in
  the data and rewrites every chain's Row_constraints from the global
  state; the draws, the collected U and Row_constraints equal the
  unsharded run's.
* a host ``callback`` that rewrites the data, calls ``mark_data_dirty``
  and sets Row_constraints through the model's properties.
* checkpoints hold the global state: a mesh run cut after 3 sweeps and
  resumed equals the uninterrupted mesh run bit for bit; a checkpoint of
  an unsharded run resumes on the mesh, and one of a mesh run resumes
  without a mesh, each equal to the uninterrupted run.
* ``profile_dir``: one trace a rank.

Tolerance against the unsharded run: rtol = atol = 1e-5."""
import os

import numpy as np
import pytest

from tests.torch_mesh_ranks import hooked_run, rank_scenarios, spawn_ranks

KEYS = ("W", "V", "sigma2", "lam2", "Tau2", "U", "Row_constraints")


@pytest.fixture(scope="module")
def ck_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    # the unsharded run's checkpoint after its first draw, for the mesh
    hooked_run(None, checkpoint=str(d / "unsharded.npz"), nsamples=1)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ck_dir):
    prof = tmp_path_factory.mktemp("prof")
    scen = [("hook", "hooked_run", {}),
            ("host", "hooked_run", dict(host=True)),
            ("resume", "run_resumed", dict(ck_dir=str(ck_dir))),
            ("profile", "run_profiled", dict(profile_dir=str(prof)))]
    outs = spawn_ranks(rank_scenarios, 4, tmp_path_factory.mktemp("rdv"),
                       (2, 2), scen)
    return outs, prof


@pytest.fixture(scope="module")
def ref():
    return {flavour: hooked_run(host=flavour == "host")
            for flavour in ("hook", "host")}


def _ok(outs, name):
    for r, o in enumerate(outs):
        assert not isinstance(o[name], str), f"rank {r}: {o[name]}"
    return [o[name] for o in outs]


def _same(got, want, exact=False):
    assert set(got["res"]) == set(want["res"])
    for key in KEYS:
        if exact:
            np.testing.assert_array_equal(got["res"][key], want["res"][key],
                                          err_msg=key)
        else:
            np.testing.assert_allclose(got["res"][key], want["res"][key],
                                       rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("flavour", ("hook", "host"))
def test_hooks_under_a_mesh_equal_the_unsharded_run(runs, ref, flavour):
    got = _ok(runs[0], flavour)
    want = ref[flavour]
    S = 2 * 4
    assert want["res"]["U"].shape == (4, 4, 2)       # no chain axis
    assert want["res"]["Row_constraints"].shape == (S, 8, 3)
    # the hook rewrote U and the rows at every sweep
    assert (np.diff(want["res"]["U"], axis=0) != 0).all(axis=(1, 2)).all()
    for r, o in enumerate(got):
        assert o["split"] == {"W": "whole", "V": "whole"}
        assert o["slack"] >= -1e-5, r
        _same(o, got[0], exact=True)
    _same(got[0], want)
    # every draw holds the rows its sweep ran under
    W, RC = want["res"]["W"], want["res"]["Row_constraints"]
    vals = np.einsum("snk,sjk->snj", W, RC[:, :, :2]) - RC[:, None, :, 2]
    assert vals.min() >= -1e-5


def test_resumed_mesh_run_equals_the_uninterrupted_one(runs):
    for o in _ok(runs[0], "resume"):
        _same(o["resumed"], o["whole"], exact=True)


def test_unsharded_checkpoint_resumes_on_the_mesh(runs, ref):
    for o in _ok(runs[0], "resume"):
        _same(o["from_unsharded"], ref["hook"])


def test_mesh_checkpoint_resumes_unsharded(runs, ck_dir, ref):
    _ok(runs[0], "resume")
    got = hooked_run(checkpoint=str(ck_dir / "mesh.npz"), resume=True)
    _same(got, ref["hook"])


def test_profile_dir_writes_one_trace_a_rank(runs):
    outs, prof = runs
    want = ["trace.json"] + [f"trace.rank{r}.json" for r in (1, 2, 3)]
    assert sorted(os.listdir(prof)) == want
    for name in want:
        assert os.path.getsize(prof / name) > 0
    assert _ok(outs, "profile")[0] == want
