"""The port's fused candidate log-likelihoods (functionalmf_tpu_torch/ops/
fused_ll.py) against the JAX package's Pallas kernels, run in interpret
mode on the CPU, and the CUDA kernels against their plain versions on a
card.

Tolerance rtol=2e-5, atol=2e-3 against JAX, as in tests/test_fused_ll.py:
the sums run in another order. On the card, rtol=1e-5, atol=1e-3."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from functionalmf_tpu.ops import fused_ll as jfl
from functionalmf_tpu_torch.ops import fused_ll as F
from functionalmf_tpu_torch.ops import fused_ll_bench as B


def jax_poisson_cell(y, tau):
    rate = jnp.clip(tau, 1e-8, None)
    y0 = jnp.where(jnp.isnan(y), 0.0, y)
    return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, want, rtol=2e-5, atol=2e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("G,k,C", [(12, 5, 300), (100, 16, 1000)])
def test_fused_row_ll_matches_jax(rng, G, k, C):
    cands = rng.gamma(2, 1, size=(G, k)).astype(np.float32)
    B = rng.gamma(1, 0.5, size=(k, C)).astype(np.float32)
    y = rng.poisson(2.0, size=C).astype(np.float32)
    y[rng.random(C) < 0.1] = np.nan
    want = jfl.fused_row_ll(jnp.asarray(cands), jnp.asarray(B),
                            jnp.asarray(y), jax_poisson_cell, interpret=True)
    got = F.fused_row_ll(_t(cands), _t(B), _t(y), F.POISSON)
    assert got.shape == (G,)
    _close(got, want)


@pytest.mark.parametrize("G,Tb,k,n", [(12, 4, 5, 70), (64, 8, 16, 128)])
def test_fused_col_block_ll_matches_jax(rng, G, Tb, k, n):
    cands3 = rng.gamma(2, 1, size=(G, Tb, k)).astype(np.float32)
    Wn = rng.gamma(1, 0.5, size=(n, k)).astype(np.float32)
    y = rng.poisson(2.0, size=(Tb, n)).astype(np.float32)
    y[rng.random((Tb, n)) < 0.1] = np.nan
    want = jfl.fused_col_block_ll(jnp.asarray(cands3), jnp.asarray(Wn),
                                  jnp.asarray(y), jax_poisson_cell,
                                  interpret=True)
    got = F.fused_col_block_ll(_t(cands3), _t(Wn), _t(y), F.POISSON)
    assert got.shape == (G,)
    _close(got, want)


def test_row_batched_matches_one_jax_call_per_row(rng):
    """(chain, row) items in one call: each equals the JAX kernel on that
    row's data and that chain's V."""
    nch, n, m, T, k, G = 2, 4, 3, 10, 3, 9
    V = rng.gamma(1, 0.5, size=(nch, m, T, k)).astype(np.float32)
    y = rng.poisson(2.0, size=(n, m, T)).astype(np.float32)
    y[rng.random((n, m, T)) < 0.1] = np.nan
    cands = rng.gamma(2, 1, size=(nch * n, G, k)).astype(np.float32)
    rc = np.repeat(np.arange(nch), n).astype(np.int32)
    ri = np.tile(np.arange(n), nch).astype(np.int32)
    got = F.fused_row_ll_batched(
        _t(cands), _t(V.reshape(nch, m * T, k)), _t(y.reshape(n, m * T)),
        _t(rc, torch.int32), _t(ri, torch.int32), F.POISSON)
    assert got.shape == (nch * n, G)
    for r in range(nch * n):
        want = jfl.fused_row_ll(
            jnp.asarray(cands[r]), jnp.asarray(V[rc[r]].reshape(m * T, k).T),
            jnp.asarray(y[ri[r]].reshape(-1)), jax_poisson_cell,
            interpret=True)
        _close(got[r], want)


@pytest.mark.parametrize("bs", [3, 4])
def test_col_block_batched_matches_one_jax_call_per_pair(rng, bs):
    """One red-black colour phase (every (chain, column, block) pair) and
    the ragged tail phase, each pair equal to the JAX kernel on its own
    data slice; T=14 leaves a tail of 2 (bs=3) or 2 (bs=4)."""
    nch, n, m, T, k, G = 2, 5, 3, 14, 2, 7
    W = rng.gamma(1, 0.5, size=(nch, n, k)).astype(np.float32)
    y = rng.poisson(2.0, size=(n, m, T)).astype(np.float32)
    y[rng.random((n, m, T)) < 0.15] = np.nan
    nb_full, rem = divmod(T, bs)
    phases = [([b * bs for b in range(0, nb_full, 2)], bs),
              ([nb_full * bs], rem)]
    for starts, Tb in phases:
        cc, jj, bb = np.meshgrid(np.arange(nch), np.arange(m),
                                 np.arange(len(starts)), indexing="ij")
        pc, pj = cc.reshape(-1), jj.reshape(-1)
        pt = np.asarray(starts)[bb.reshape(-1)]
        P = len(pc)
        cands = rng.gamma(2, 1, size=(P, G, Tb, k)).astype(np.float32)
        got = F.fused_col_block_ll_batched(
            _t(cands), _t(W), _t(y), _t(pc, torch.int32),
            _t(pj, torch.int32), _t(pt, torch.int32), F.POISSON)
        assert got.shape == (P, G)
        for p in range(P):
            yb = y[:, pj[p], pt[p]:pt[p] + Tb].T                   # (Tb, n)
            want = jfl.fused_col_block_ll(
                jnp.asarray(cands[p]), jnp.asarray(W[pc[p]]),
                jnp.asarray(yb), jax_poisson_cell, interpret=True)
            _close(got[p], want)


def test_plain_path_only_for_cpu_and_checks_shapes(rng):
    cands = torch.rand(2, 3, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        F.fused_row_ll_batched(cands, torch.rand(1, 5, 3), torch.rand(2, 5),
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), F.POISSON)
    meta = torch.empty(1, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no fused_ll path"):
        F.fused_row_ll_batched(meta, torch.empty(1, 5, 4, device="meta"),
                               torch.empty(1, 5, device="meta"),
                               torch.empty(1, dtype=torch.int32,
                                           device="meta"),
                               torch.empty(1, dtype=torch.int32,
                                           device="meta"), F.POISSON)


# (kind, items, units, cells a slot) of every launch on the paths at
# 19x19x228: the W update at nchains 1 and 4; the V updates' colour phase
# at nchains 1 and 4, seq round, tail, joint; and a joint update at T=1000
PATH_LAUNCHES = [("row", 19, 4332, 0), ("row", 76, 4332, 0),
                 ("col", 266, 8, 19), ("col", 1064, 8, 19),
                 ("col", 19, 8, 19), ("col", 19, 4, 19),
                 ("col", 19, 228, 19), ("col", 19, 1000, 19)]


def _covered_once(plan, units, G):
    """What the kernels walk under ``plan`` (csrc/fused_ll.cu): each block
    its unit range in chunks, each pass 32 lanes x 4 candidates."""
    units_seen = np.zeros(units, int)
    for lo, hi in plan["blocks"]:
        assert hi > lo
        for u0 in range(lo, hi, plan["chunk"]):
            units_seen[u0:min(hi, u0 + plan["chunk"])] += 1
    cands_seen = np.zeros(G, int)
    for g0, gp in plan["passes"]:
        assert 1 <= gp <= 128
        for lane in range(32):
            for j in range(4):
                if lane + 32 * j < gp:
                    cands_seen[g0 + lane + 32 * j] += 1
    return (units_seen == 1).all() and (cands_seen == 1).all()


@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("kind,items,units,n", PATH_LAUNCHES)
def test_launch_plan_covers_every_cell_and_candidate_once(kind, items,
                                                          units, n, ep):
    G, k = 101, 5
    plan = F._launch_plan(kind, items, units, G, k, n, ep)
    assert _covered_once(plan, units, G)
    assert 1 <= plan["cluster"] <= 8 and len(plan["blocks"]) == \
        plan["cluster"]
    assert plan["grid"] == items * plan["cluster"]
    # an item of 1024 cells or more is split to about 1.5 x 132 blocks in
    # all, a smaller one stays in one block
    cells = units * max(n, 1)
    assert plan["cluster"] == 1 if cells < 1024 else \
        plan["grid"] >= min(132, items * 8)
    assert plan["smem"] == F._smem_bytes(kind, plan["chunk"], G, k, n, ep)
    assert plan["smem"] <= 232_448


@pytest.mark.parametrize("kind,units,n", [("row", 4332, 0), ("col", 228, 19),
                                          ("col", 3, 19)])
def test_launch_plan_runs_passes_for_wide_k_and_many_candidates(kind, units,
                                                                n):
    G, k = 300, 32
    plan = F._launch_plan(kind, 5, units, G, k, n, True)
    assert len(plan["passes"]) == 3
    assert _covered_once(plan, units, G)
    assert plan["smem"] <= 232_448


def test_launch_plan_refuses_a_slot_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        F._launch_plan("col", 19, 8, 101, 32, 4000, True)


def test_work_counts_the_data_the_kernels_need():
    """The bound's inputs from a tiny case: a NaN y drops its log and,
    without EP, its pair; with EP it keeps its pair."""
    cands = torch.ones(1, 3, 2)
    bt = torch.ones(1, 4, 2)
    y = torch.tensor([[1.0, float("nan"), 2.0, 3.0]])
    idx = torch.zeros(1, dtype=torch.int32)
    case = B.Case("fused_row_ll", "tiny", (cands, bt, y, idx, idx))
    w = B.work(case)
    assert w["pairs"] == 3 * 3 and w["sfu"] == 3 * 3
    assert w["flops"] == 3 * (3 * 2 * 2 + 3 * B.POISSON_FLOPS)
    assert w["bytes"] == 4 * (6 + 3 + 8 + 2 + 4)
    ep = B.Case("fused_row_ll_ep", "tiny", (cands, bt, y, idx, idx),
                (torch.ones_like(y), torch.ones_like(y)))
    assert B.work(ep)["pairs"] == 3 * 4 and B.work(ep)["sfu"] == 3 * 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G,k,C", [(101, 5, 4332), (12, 16, 300)])
def test_row_kernel_matches_plain_on_card(rng, cuda_device, G, k, C):
    R, nch = 6, 2
    cands = torch.as_tensor(rng.gamma(2, 1, size=(R, G, k)),
                            dtype=torch.float32, device=cuda_device)
    bt = torch.as_tensor(rng.gamma(1, 0.5, size=(nch, C, k)),
                         dtype=torch.float32, device=cuda_device)
    y = rng.poisson(2.0, size=(3, C)).astype(np.float32)
    y[rng.random((3, C)) < 0.1] = np.nan
    y = torch.as_tensor(y, device=cuda_device)
    rc = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32,
                      device=cuda_device)
    ri = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32,
                      device=cuda_device)
    before = F.launch_counts["fused_row_ll"]
    got = F.fused_row_ll_batched(cands, bt, y, rc, ri, F.POISSON)
    assert F.launch_counts["fused_row_ll"] == before + 1
    want = F.row_ll_plain(cands, bt, y, rc, ri, F.POISSON)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("Tb", [8, 4])
def test_col_kernel_matches_plain_on_card(rng, cuda_device, Tb):
    nch, n, m, T, k, G, P = 2, 19, 4, 30, 5, 101, 10
    cands = torch.as_tensor(rng.gamma(2, 1, size=(P, G, Tb, k)),
                            dtype=torch.float32, device=cuda_device)
    w = torch.as_tensor(rng.gamma(1, 0.5, size=(nch, n, k)),
                        dtype=torch.float32, device=cuda_device)
    y = rng.poisson(2.0, size=(n, m, T)).astype(np.float32)
    y[rng.random((n, m, T)) < 0.1] = np.nan
    y = torch.as_tensor(y, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    pc = torch.as_tensor(rng.integers(0, nch, P), **i32)
    pj = torch.as_tensor(rng.integers(0, m, P), **i32)
    pt = torch.as_tensor(rng.integers(0, T - Tb + 1, P), **i32)
    got = F.fused_col_block_ll_batched(cands, w, y, pc, pj, pt, F.POISSON)
    want = F.col_block_ll_plain(cands, w, y, pc, pj, pt, F.POISSON)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_kernel_refuses_cell_without_specialisation(cuda_device):
    plain = F.CellFn(None, F.POISSON.torch_fn)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        F.fused_row_ll_batched(torch.rand(1, 4, 2, device=cuda_device),
                               torch.rand(1, 6, 2, device=cuda_device),
                               torch.rand(1, 6, device=cuda_device), idx,
                               idx, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["R=76,", "P=1064,", "Tb=1000"])
def test_kernels_match_plain_at_the_wider_path_shapes(cuda_device, shape):
    """nchains=4 (R=76; P=1064 colour phase) and a joint update at T=1000,
    which the kernels no longer refuse: each kernel, with and without EP,
    within rtol=1e-5 / atol=1e-3 of its plain version and bit-identical
    over two launches."""
    Y, W, V, pol = B.synthetic_problem()
    cases = [c for c in B.path_cases(cuda_device, Y, W, V, pol)
             if shape in c.shape]
    assert len(cases) == 2
    for case in cases:
        got, again = case.kernel(), case.kernel()
        want = case.plain()
        torch.cuda.synchronize()
        B.compare(got, want)
        assert torch.equal(got, again)
