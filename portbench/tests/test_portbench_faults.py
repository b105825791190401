"""Each fault a cell can have, planted under a run that skips the look
for a card, makes ``correct`` false; each control (the reference from
inputs rounded to TF32 or bfloat16 in the program's place) reads beyond a
limit where the program reads within every one. One chip, no exchange
between chips: that fault does not apply."""
import pytest
import torch

CELLS = ("tiny-poisson", "tiny-gamma")
GAPS = ("ll_gap", "ellipse_gap", "scale_gap", "state_gap")


def _checks(r):
    return {k: c["value"] for k, c in r["checks"].items()}


def _model_class():
    from functionalmf_tpu_torch.models import constrained
    return constrained.ConstrainedNonconjugateBayesianTensorFiltering


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(run_tiny, cell):
    r = run_tiny(cell, seed=3, control=("tf32", "bf16"))
    assert r["correct"] is True, r["checks"]
    for name, numbers in r["control_checks"].items():
        beyond = [k for k in GAPS if numbers[k] > r["checks"][k]["limit"]]
        assert beyond, (name, numbers)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sweep_that_returns_its_state(run_tiny, monkeypatch, cell):
    monkeypatch.setattr(_model_class(), "_make_sweep",
                        lambda self: (lambda state, y, gen: state))
    r = run_tiny(cell)
    assert r["correct"] is False
    assert _checks(r)["wrong_steps"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("which", ["first_round", "v_update"])
def test_a_skipped_part_of_the_sweep(run_tiny, monkeypatch, cell, which):
    """One round of the V update left out (a red-black colour, a seq
    block), or the whole V update."""
    cls = _model_class()
    if which == "v_update":
        monkeypatch.setattr(cls, "_update_V_gass",
                            lambda self, state, y, gen: state)
    else:
        real = cls._phase_update

        def phase(self, X, W, DtLD, G, mu_part, y, ph, gen):
            if ph.starts[0] == 0:
                return X
            return real(self, X, W, DtLD, G, mu_part, y, ph, gen)
        monkeypatch.setattr(cls, "_phase_update", phase)
    r = run_tiny(cell, seed=5)
    assert r["correct"] is False
    assert _checks(r)["wrong_steps"] > 0


def _gass_fault(monkeypatch, change):
    """Run the program's GASS step on ``change(kw)``: under the
    benchmark's wrapper, which sees the step's own arguments."""
    from functionalmf_tpu_torch.models import constrained
    real = constrained.gass_grid

    def gass(x, loglik, A, c, **kw):
        return real(x, loglik, A, c, **change(dict(kw)))
    monkeypatch.setattr(constrained, "gass_grid", gass)


@pytest.mark.parametrize("cell", CELLS)
def test_a_wrong_slice_height(run_tiny, monkeypatch, cell):
    """The GASS slice set at the current point's likelihood, its uniform
    left out: the moves keep to fewer candidates than the reference's."""
    _gass_fault(monkeypatch, lambda kw: dict(
        kw, log_u=torch.zeros_like(kw["log_u"])))
    r = run_tiny(cell, seed=6)
    assert r["correct"] is False
    assert _checks(r)["wrong_steps"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_candidates_from_a_bfloat16_proposal(run_tiny, monkeypatch, cell):
    """The ellipse's proposal draw v rounded to bfloat16."""
    _gass_fault(monkeypatch, lambda kw: dict(
        kw, v=kw["v"].to(torch.bfloat16).float()))
    r = run_tiny(cell, seed=7)
    assert r["correct"] is False
    assert _checks(r)["ellipse_gap"] > r["checks"]["ellipse_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("slope", [3.0, 0.5])
def test_a_scale_move_with_a_wrong_density(run_tiny, monkeypatch, cell,
                                           slope):
    """Each scale move's log density off by ``slope`` x (a prior term or a
    Jacobian of the move changed), as the model hands it to the slice
    sampler."""
    cls = _model_class()
    real = cls._slice_1d

    def slice_1d(self, x0, logdensity, lo, hi, gen):
        return real(self, x0, lambda x: logdensity(x) + slope * x, lo, hi,
                    gen)
    monkeypatch.setattr(cls, "_slice_1d", slice_1d)
    r = run_tiny(cell, seed=8)
    assert r["correct"] is False
    assert _checks(r)["scale_gap"] > r["checks"]["scale_gap"]["limit"]


def _poisson_fault(monkeypatch, change):
    """Plant ``change(out)`` on the fused functions' answers where the
    model looks them up, under the benchmark's wrappers."""
    from functionalmf_tpu_torch.models import constrained
    for name in ("fused_row_ll_batched", "fused_col_block_ll_batched"):
        real = getattr(constrained, name)
        monkeypatch.setattr(constrained, name,
                            lambda *a, _real=real, **kw: change(_real(*a,
                                                                      **kw)))


def _gamma_fault(monkeypatch, change):
    cls = _model_class()
    for name in ("_w_loglik_blackbox", "_v_loglik_blackbox"):
        real = getattr(cls, name)

        def lifted(self, *a, _real=real):
            inner = _real(self, *a)
            return lambda cands: change(inner(cands))
        monkeypatch.setattr(cls, name, lifted)


def _half_left_out(out):
    """The second half of the items left out, their answers the mean of
    the first half's."""
    h = out.shape[0] // 2
    out = out.clone()
    out[h:] = out[:h].mean(0, keepdim=True)
    return out


def _altered(out):
    """One answer altered where it is produced: the last item's
    log-likelihoods off by a tenth of their magnitude."""
    out = out.clone()
    out[-1] = out[-1] * 1.1 + 1.0
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("change", [_half_left_out, _altered])
def test_a_wrong_answer(run_tiny, monkeypatch, cell, change):
    plant = _poisson_fault if cell == "tiny-poisson" else _gamma_fault
    plant(monkeypatch, change)
    r = run_tiny(cell, seed=4)
    assert r["correct"] is False
    assert _checks(r)["ll_gap"] > r["checks"]["ll_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("politics-redblack-manychain",
                                  "doseresponse-seq-c4"))
def test_cell_on_the_card(cell):
    """A short run of each cell on the card reads correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench import harness
    r = harness.run_cell(cell, 2**31 + 99, 3.0, 0, "cuda", t_start=None,
                         log=lambda m: None)
    assert r["correct"] is True, r["checks"]
