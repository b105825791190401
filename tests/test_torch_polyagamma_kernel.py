"""The Polya-Gamma kernel (functionalmf_tpu_torch/csrc/polyagamma.cu) and
its wrapper (``ops/polyagamma.py:polya_gamma``).

Without a card: the wrapper's routing (CPU tensors take the plain version
and launch nothing; another dtype, two devices or a device of another type
raise) and the C entry's ctypes signature against its declaration in the
source. On a card (marker ``cuda``): the kernel against the plain version,
both on the card, on the same numpy-made noise, within 4 float32 eps of
the sum of the terms' magnitudes (a lane whose acceptance test lies within
rounding of its threshold left out, as the benchmark's ``pg_gap`` does),
the injected-g variant, a chain slice bit for bit, one launch a sweep
of a short negative-binomial run in the launch count and the run record,
and the kernel against the JAX package's draws recorded in
tests/pg_jax_draws.npz (also held to the plain version on the CPU here).
The yardstick of each comparison is
``ops/polyagamma_bench.py:reference64``, the same draw in float64.

The file imports no jax, so that it also runs on the card: ``python -m
pytest --noconftest -p no:cacheprovider tests/test_torch_polyagamma_kernel.py
-q``."""
import ctypes
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from functionalmf_tpu_torch import NegativeBinomialBayesianTensorFiltering
from functionalmf_tpu_torch.ops import _build, polyagamma
from functionalmf_tpu_torch.ops.polyagamma import (polya_gamma,
                                                   polya_gamma_plain)
from functionalmf_tpu_torch.ops.polyagamma_bench import reference64
from functionalmf_tpu_torch.utils import telemetry

EPS32 = float(np.finfo(np.float32).eps)
TERMS, ROUNDS = 16, 6
SRC = Path(_build.__file__).resolve().parent.parent / "csrc" / "polyagamma.cu"
RECORDED = Path(__file__).with_name("pg_jax_draws.npz")
B_GRID = (0.0, 0.3, 1.0, 7.5, 49.9, 50.0, 300.0)
C_GRID = (0.0, 0.01, -0.01, 0.3, -0.3, 2.0, -2.0, 25.0, -25.0)


def _noise(rng, shape, rounds=ROUNDS, terms=TERMS):
    """draw_gamma_mt_noise's triple from numpy, clamped as it clamps."""
    lead = (rounds, terms) + tuple(shape)
    x = rng.standard_normal(lead).astype(np.float32)
    u = np.maximum(rng.random(lead, dtype=np.float32), 1e-12)
    ub = np.maximum(rng.random((terms,) + tuple(shape), dtype=np.float32),
                    1e-12)
    return tuple(torch.from_numpy(t) for t in (x, u, ub))


def _grid(reps):
    """Every (b, c) of the grids, ``reps`` cells each, as float32 (S,)."""
    b, c = np.meshgrid(np.asarray(B_GRID), np.asarray(C_GRID), indexing="ij")
    return (torch.as_tensor(np.repeat(b.ravel(), reps), dtype=torch.float32),
            torch.as_tensor(np.repeat(c.ravel(), reps), dtype=torch.float32))


# ----------------------------------------------------------------------
# without a card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", ["b", "c", "z", "g", "x"])
def test_wrapper_raises_on_float64_tensors(which):
    args = dict(b=torch.full((3,), 2.0), c=torch.zeros(3),
                z=torch.zeros(3), g=torch.ones(TERMS, 3))
    noise = list(_noise(np.random.default_rng(0), (3,)))
    if which == "x":
        noise[0] = noise[0].double()
    else:
        args[which] = args[which].double()
    with pytest.raises(TypeError, match="float32"):
        polya_gamma(None, args["b"], args["c"], num_terms=TERMS,
                    g=args["g"], z=args["z"], gamma_noise=tuple(noise))


def test_wrapper_raises_on_mixed_devices():
    with pytest.raises(ValueError, match="several devices"):
        polya_gamma(None, torch.full((3,), 2.0),
                    torch.zeros(3, device="meta"), z=torch.zeros(3))


def test_wrapper_raises_on_a_device_without_a_path():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no polya_gamma path"):
        polya_gamma(None, torch.full((3,), 2.0, **meta),
                    torch.zeros(3, **meta))


@pytest.mark.parametrize("variant", ["noise", "g", "torch_gamma"])
def test_cpu_call_takes_the_plain_path_and_launches_nothing(variant):
    """The plain version on CPU tensors: the kernel's counts stay where
    they were, and the draw is the float64 one from the same noise
    (within 64 float32 eps of its terms' magnitudes, as
    tests/test_torch_negbinom_reference.py holds it to the benchmark's
    reference)."""
    rng = np.random.default_rng(1)
    b, c = _grid(4)
    x, u, ub = _noise(rng, b.shape)
    z = torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32))
    before = dict(polyagamma.launch_counts)
    if variant == "noise":
        got = polya_gamma(None, b, c, num_terms=TERMS, z=z,
                          gamma_noise=(x, u, ub))
        want, scale, amb, _ = reference64(b, c, z, (x, u, ub))
        gap = (got.double() - want).abs() / scale.clamp_min(1e-300)
        assert gap[~amb].max() <= 64 * EPS32
    elif variant == "g":
        g = torch.ones(TERMS, b.numel())
        got = polya_gamma(None, b, c, num_terms=TERMS, z=z, g=g)
        assert torch.isfinite(got).all()
    else:
        got = polya_gamma(torch.Generator().manual_seed(2), b, c,
                          num_terms=TERMS, use_mt=False, z=z)
        assert torch.isfinite(got).all()
    assert dict(polyagamma.launch_counts) == before
    assert (got[b == 0] == 0).all() and (got[b > 0] > 0).all()


def _c_params(name):
    """The parameter declarations of the extern "C" function ``name``."""
    src = SRC.read_text()
    m = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", src)
    assert m, f"{name} not declared in {SRC.name}"
    return [p.strip() for p in m.group(1).split(",")]


def _ctype(decl):
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(None, 1)[0].replace("const", "").strip()
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[kind]


def test_declare_sets_the_polya_gamma_argtypes_from_its_c_declaration():
    """Every pointer and the stream as c_void_p (a Python int passed as a
    c_int would cut a 64-bit address), the cell count as a 64-bit int; a
    stand-in for the library, so no card and no nvcc."""
    lib = mock.MagicMock()
    assert _build.declare(lib) is lib
    params = _c_params("fmf_polya_gamma")
    assert len(params) == 13
    assert lib.fmf_polya_gamma.argtypes == [_ctype(p) for p in params]
    assert lib.fmf_polya_gamma.restype is ctypes.c_int
    assert lib.fmf_polya_gamma.argtypes[-1] is ctypes.c_void_p   # stream


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _nb_cell_bc(dev, nchains=2, sweeps=3):
    """(b, c) of the negative-binomial politics model's Polya-Gamma draw
    (its settings at 19x19x228, k=5, on bench.py's counts at seed 3, as
    the benchmark's cell draws them), as the model passes them after a
    few sweeps, flattened."""
    from functionalmf_tpu_torch.examples import recipe
    from functionalmf_tpu_torch.models import binomial
    Y = recipe.make_data(np.random.default_rng(3), (19, 19, 228, 5))[0][0]
    model = NegativeBinomialBayesianTensorFiltering(
        19, 19, 228, device=dev, seed=3, nchains=nchains, nembeds=5,
        tf_order=2, sigma2_init=0.5, lam2_init=0.1, nu2_init=1,
        rdims=(0, 1, 2), nmetropolis=30, rpropstdev=0.1, rstdev=1.0,
        pg_num_terms=TERMS)
    seen, pg0 = [], binomial.polya_gamma

    def keep(gen, b, c, **kw):
        seen.append((b.expand(c.shape).reshape(-1).cpu(),
                     c.reshape(-1).cpu()))
        return pg0(gen, b, c, **kw)

    with mock.patch.object(binomial, "polya_gamma", keep):
        model.run_gibbs(Y, nburn=sweeps - 1, nthin=1, nsamples=1,
                        verbose=False)
    return seen[-1]


def _kernel_against_plain(dev, b, c, rng):
    """The kernel and the plain version on the card from the same noise:
    their gap over the terms' magnitudes, the lanes near a threshold, and
    the kernel's omega."""
    x, u, ub = _noise(rng, b.shape)
    z = torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32))
    args = [t.to(dev) for t in (b, c, z, x, u, ub)]
    plain = polya_gamma_plain(None, *args[:2], num_terms=TERMS, z=args[2],
                              gamma_noise=tuple(args[3:]))
    before = polyagamma.launch_counts["polya_gamma"]
    got = polya_gamma(None, *args[:2], num_terms=TERMS, z=args[2],
                      gamma_noise=tuple(args[3:]))
    torch.cuda.synchronize()
    assert polyagamma.launch_counts["polya_gamma"] == before + 1
    _, scale, amb, _ = reference64(b, c, z, (x, u, ub))
    gap = (got.cpu().double() - plain.cpu().double()).abs() \
        / scale.clamp_min(1e-300)
    return gap, amb, got.cpu()


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_grid_on_card(cuda_device):
    """b in {0, 0.3, 1, 7.5, 49.9, 50, 300} x c in {0, +-0.01, +-0.3, +-2,
    +-25}, 2000 cells each: both branches, the boost, b = 0, both
    series cut-offs."""
    b, c = _grid(2000)
    gap, amb, got = _kernel_against_plain(cuda_device, b, c,
                                          np.random.default_rng(5))
    assert gap[~amb].max() <= 4 * EPS32
    assert int(amb.sum()) <= b.numel() // 100
    assert (got[b == 0] == 0).all() and (got[b > 0] > 0).all()


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_nb_cells_own_draw_on_card(cuda_device):
    b, c = _nb_cell_bc(cuda_device)
    sl = slice(0, 400_000)
    gap, amb, _ = _kernel_against_plain(cuda_device, b[sl], c[sl],
                                        np.random.default_rng(6))
    assert gap[~amb].max() <= 4 * EPS32
    assert int(amb.sum()) <= 4000


@pytest.mark.cuda
def test_kernel_reads_injected_g_on_card(cuda_device):
    """The variant that reads g in place of the rounds, and the card's
    ``use_mt=False`` draws through it."""
    rng = np.random.default_rng(7)
    b, c = _grid(500)
    g = torch.from_numpy(rng.gamma(2.0, 1.0, (TERMS,) + tuple(b.shape))
                         .astype(np.float32))
    z = torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32))
    args = [t.to(cuda_device) for t in (b, c, z, g)]
    plain = polya_gamma_plain(None, *args[:2], num_terms=TERMS, z=args[2],
                              g=args[3]).cpu()
    before = dict(polyagamma.launch_counts)
    got = polya_gamma(None, *args[:2], num_terms=TERMS, z=args[2],
                      g=args[3]).cpu()
    _, scale, _, _ = reference64(b, c, z, g=g)
    gap = (got.double() - plain.double()).abs() / scale.clamp_min(1e-300)
    assert gap.max() <= 4 * EPS32
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    drawn = polya_gamma(gen, b.to(cuda_device), c.to(cuda_device),
                        num_terms=TERMS, use_mt=False)
    assert torch.isfinite(drawn).all() and (drawn[b.to(cuda_device) == 0]
                                            == 0).all()
    assert polyagamma.launch_counts["polya_gamma_g"] == \
        before["polya_gamma_g"] + 2
    assert polyagamma.launch_counts["polya_gamma"] == before["polya_gamma"]


@pytest.mark.cuda
def test_a_chain_slice_equals_the_whole_batch_bit_for_bit_on_card(
        cuda_device):
    """A mesh rank's chains: the noise sliced along the chain axis (not
    contiguous) gives the whole batch's omega of those chains, bit for
    bit."""
    rng = np.random.default_rng(9)
    shape = (4, 19, 19, 12)
    b = torch.from_numpy(rng.choice([0.0, 0.4, 3.0, 12.0, 80.0], shape)
                         .astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)) \
        .to(cuda_device)
    x, u, ub = (t.to(cuda_device) for t in _noise(rng, shape))
    z = torch.randn(shape, device=cuda_device)
    whole = polya_gamma(None, b, c, num_terms=TERMS, z=z,
                        gamma_noise=(x, u, ub))
    part = polya_gamma(None, b[1:3], c[1:3], num_terms=TERMS, z=z[1:3],
                       gamma_noise=(x[:, :, 1:3], u[:, :, 1:3],
                                    ub[:, 1:3]))
    assert torch.equal(part, whole[1:3])


@pytest.mark.cuda
def test_one_launch_a_sweep_in_the_count_and_the_run_record_on_card(
        cuda_device):
    rng = np.random.default_rng(10)
    Y = rng.poisson(3.0, (6, 5, 24)).astype(float)
    Y[0, 0] = np.nan
    model = NegativeBinomialBayesianTensorFiltering(
        6, 5, 24, device=cuda_device, seed=4, nchains=2, nembeds=3,
        tf_order=2, rdims=(0, 1, 2))
    before = dict(polyagamma.launch_counts)
    model.run_gibbs(Y, nburn=4, nthin=1, nsamples=3, verbose=False)
    sweeps = model.last_run["sweeps"]
    assert sweeps == 7
    assert polyagamma.launch_counts["polya_gamma"] == \
        before["polya_gamma"] + sweeps
    launches = model.last_run["counts"]["launches"]
    assert launches["polya_gamma"] == sweeps
    assert launches["polya_gamma_g"] == 0
    assert set(launches) == set(telemetry.launch_counts())


# ----------------------------------------------------------------------
# against the JAX package's draws, recorded (the card's machine has no jax)
# ----------------------------------------------------------------------
def recorded_jax_case(use_mt):
    """tests/pg_jax_draws.npz as tests/test_torch_polyagamma.py's
    ``_jax_pg_case`` gives it: b, c, z, the JAX package's draw, and the
    Marsaglia-Tsang noise (``use_mt``) or the gammas behind it."""
    rec = np.load(RECORDED)
    case = {k: torch.from_numpy(rec[k]) for k in ("b", "c", "z")}
    if use_mt:
        case["noise"] = tuple(torch.from_numpy(rec[k])
                              for k in ("x", "u", "ub"))
        case["want"] = torch.from_numpy(rec["want_mt"])
    else:
        case["g"] = torch.from_numpy(rec["g_std"])
        case["want"] = torch.from_numpy(rec["want_std"])
    return case


def kernel_against_jax_draw(case, use_mt, dev):
    """``polya_gamma`` on ``dev`` from the case's noise (or gammas) and
    normals against the JAX package's draw, at
    tests/test_torch_polyagamma.py's tolerance (rtol=1e-5, atol=1e-12), a
    lane whose acceptance test lies within rounding of its threshold left
    out; on a card, one launch of the kernel."""
    kind = "polya_gamma" if use_mt else "polya_gamma_g"
    before = dict(polyagamma.launch_counts)
    args = dict(z=case["z"].to(dev), num_terms=TERMS)
    if use_mt:
        args["gamma_noise"] = tuple(t.to(dev) for t in case["noise"])
        amb = reference64(case["b"], case["c"], case["z"],
                          case["noise"])[2].reshape(case["b"].shape)
    else:
        args["g"] = case["g"].to(dev)
        amb = torch.zeros(case["b"].shape, dtype=torch.bool)
    got = polya_gamma(None, case["b"].to(dev), case["c"].to(dev),
                      **args).cpu()
    launched = int(dev.type == "cuda")
    assert polyagamma.launch_counts == {
        k: v + launched * (k == kind) for k, v in before.items()}
    assert int(amb.sum()) <= 2
    np.testing.assert_allclose(got[~amb].numpy(), case["want"][~amb].numpy(),
                               rtol=1e-5, atol=1e-12)
    b = case["b"]
    assert (got[b == 0] == 0).all() and (got[b > 0] > 0).all()


@pytest.mark.parametrize("use_mt", [True, False])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_polya_gamma_matches_the_recorded_jax_draw(where, use_mt):
    """The plain version here, the kernel on a card."""
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    kernel_against_jax_draw(recorded_jax_case(use_mt), use_mt,
                            torch.device(where))
