"""The negative-binomial family: a tiny cell added as files runs and reads
correct, its wrappers leave the draws as they are, and every planted fault
(in the R moves, the Polya-Gamma draw, the W or the V draw, or a step left
out) reads correct false. On the CPU, at 6x5x24, k=3, 4 chains."""
import inspect
import json
import textwrap

import numpy as np
import pytest
import torch

from portbench import harness

TINY_NB = dict(sizes=dict(nrows=6, ncols=5, ndepth=24, nembeds=3),
               traffic=dict(nchains=4, nthin=2, sweeps_per_second=20))


@pytest.fixture(scope="module")
def nb_copy(bench_copy):
    """The benchmark copy with a tiny negative-binomial cell added as
    files."""
    cfg = json.loads((bench_copy / "configs" / "negbinom-politics.json")
                     .read_text())
    cfg.update(TINY_NB["sizes"])
    (bench_copy / "configs" / "tiny-nb.json").write_text(json.dumps(cfg))
    (bench_copy / "traffic" / "tiny-nb.json").write_text(
        json.dumps(TINY_NB["traffic"]))
    (bench_copy / "workloads" / "tiny-nb.json").write_text(json.dumps(dict(
        config="tiny-nb", traffic="tiny-nb", chips=1,
        why="a test's tiny cell")))
    return bench_copy


def _run(root, seed=3, **kw):
    torch.set_num_threads(2)
    return harness.run_cell("tiny-nb", seed, 0.5, 0, "cpu", t_start=None,
                            log=lambda m: None, root=root, **kw)


def _mutate(fn, old, new):
    """``fn`` compiled again from its source with ``old`` replaced by
    ``new``, in its module's namespace: a planted fault."""
    src = textwrap.dedent(inspect.getsource(fn))
    assert old in src
    ns = {}
    exec(compile(src.replace(old, new), "<fault>", "exec"),
         fn.__globals__, ns)
    return ns[fn.__name__]


def test_a_negbinom_cell_added_as_files_runs(nb_copy):
    r = _run(nb_copy, seed=2**31 + 11, control=("tf32",))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"wrong_steps", "r_wrong_moves", "r_gap",
                                "pg_gap", "w_gap", "v_gap"}
    # the TF32 control fails at least one limit
    ctrl = r["control_checks"]["tf32"]
    assert any(ctrl[k] > c["limit"] for k, c in r["checks"].items())


def test_the_wrappers_leave_the_draws_as_they_are(nb_copy):
    """A window with the family's wrappers installed and a captured sweep
    draws what the model draws without them, bit for bit."""
    wl = harness.load_workload("tiny-nb", nb_copy)
    fam = harness.family(wl["config_data"], nb_copy)
    dev = torch.device("cpu")
    runs = []
    for wrapped in (False, True):
        cell = fam.build(wl["config_data"], wl["traffic_data"], 5, dev)
        rec = harness.Recorder(5, dev)
        rec.choose_captures(6, cell.nchains)
        restore = cell.install(rec) if wrapped else (lambda: None)
        try:
            runs.append(cell.model.run_gibbs(
                cell.data, nburn=2, nthin=2, nsamples=2, verbose=False,
                traced_callback=rec.hook))
        finally:
            restore()
        if wrapped:
            kinds = {c["kind"] for c in rec.captures}
            assert {"r_moves", "pg", "prior", "w", "v"} <= kinds
    for key in ("W", "V", "R", "nu2", "sigma2", "lam2", "Tau2"):
        np.testing.assert_array_equal(runs[0][key], runs[1][key])


def _invert_acceptance(monkeypatch):
    from functionalmf_tpu_torch.models import negbinom
    cls = negbinom.NegativeBinomialBayesianTensorFiltering
    monkeypatch.setattr(cls, "_update_R", _mutate(
        cls._update_R, "accept = (u[i] <= prob)", "accept = (u[i] > prob)"))


def _eight_terms(monkeypatch):
    from functionalmf_tpu_torch.models import binomial
    cls = binomial.BinomialBayesianTensorFiltering
    pg0 = cls._pg_update

    def pg(self, *a, **kw):
        self.pg_num_terms = 8
        return pg0(self, *a, **kw)
    monkeypatch.setattr(cls, "_pg_update", pg)


def _tail_dropped(monkeypatch):
    from functionalmf_tpu_torch.models import binomial
    from functionalmf_tpu_torch.ops import polyagamma
    monkeypatch.setattr(binomial, "polya_gamma", _mutate(
        polyagamma.polya_gamma, "gamma_draw = trunc + tail",
        "gamma_draw = trunc"))


def _v_other_noise(monkeypatch):
    from functionalmf_tpu_torch.models import gaussian
    v0 = gaussian.sample_mvn_block_banded_retiled

    def banded(gen, bands, **kw):
        kw["z_tiled"] = torch.randn_like(kw["z_tiled"])
        return v0(gen, bands, **kw)
    monkeypatch.setattr(gaussian, "sample_mvn_block_banded_retiled", banded)


def _w_gram_bf16(monkeypatch):
    from functionalmf_tpu_torch.models import gaussian
    terms0 = gaussian.w_likelihood_terms

    def terms(w8, wy, Vf):
        Q, mu = terms0(w8, wy, Vf)
        return Q.to(torch.bfloat16).float(), mu
    monkeypatch.setattr(gaussian, "w_likelihood_terms", terms)


def _r_moves_skipped(monkeypatch):
    from functionalmf_tpu_torch.models import negbinom
    cls = negbinom.NegativeBinomialBayesianTensorFiltering
    init0 = cls.__init__

    def init(self, *a, **kw):
        init0(self, *a, **kw)
        self.sample_R = False
    monkeypatch.setattr(cls, "__init__", init)


@pytest.mark.parametrize("plant,reads", [
    (_invert_acceptance, "r_wrong_moves"),
    (_eight_terms, "pg_gap"),
    (_tail_dropped, "pg_gap"),
    (_v_other_noise, "v_gap"),
    (_w_gram_bf16, "w_gap"),
    (_r_moves_skipped, "wrong_steps"),
])
def test_a_planted_fault_reads_correct_false(nb_copy, monkeypatch, plant,
                                             reads):
    plant(monkeypatch)
    r = _run(nb_copy)
    assert r["correct"] is False
    assert r["checks"][reads]["value"] > r["checks"][reads]["limit"]
