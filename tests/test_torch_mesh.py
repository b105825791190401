"""The port's mesh module against the JAX package's, in this process.

* ``feasible_spec`` equals ``functionalmf_tpu.parallel.mesh._feasible_spec``
  on meshes of the 8 virtual CPU devices, over a grid of shapes, specs and
  mesh sizes.
* Each model's ``state_partition_specs()`` equals the JAX model's, built
  with the same arguments, and covers every state key.
* A model whose device is not the mesh's raises.
* Two builders started at once compile once (the build directory's lock).

The runs on spawned ranks are in tests/test_torch_mesh_runs.py,
tests/test_torch_mesh_chains.py, tests/test_torch_mesh_jax.py and, for the
black-box models and the driver's options, tests/test_torch_mesh_blackbox.py,
tests/test_torch_mesh_blackbox_jax.py, tests/test_torch_mesh_nonconjugate.py
and tests/test_torch_mesh_driver.py."""
import itertools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from functionalmf_tpu_torch.parallel.mesh import (DP_AXIS, MP_AXIS, Mesh,
                                                  feasible_spec, make_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_mesh(n_dp, n_mp, device="cpu"):
    """A mesh point without a process group: enough for a constructor or
    for slicing, not for a collective."""
    return Mesh(n_dp, n_mp, {DP_AXIS: 0, MP_AXIS: 0}, device,
                {DP_AXIS: None, MP_AXIS: None})


SPECS = [(DP_AXIS,), (DP_AXIS, MP_AXIS), (None, MP_AXIS), (MP_AXIS,),
         (DP_AXIS, None, MP_AXIS), (), (None,), (DP_AXIS, MP_AXIS, None)]
SHAPES = [(), (4,), (3,), (2, 8), (4, 19, 5), (8, 6, 6, 2), (6, 12, 7),
          (1, 2, 3), (2, 4, 8, 1)]
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (1, 8), (8, 1)]


@pytest.mark.parametrize("n_dp, n_mp", MESHES)
def test_feasible_spec_matches_jax(n_dp, n_mp):
    from jax.sharding import PartitionSpec as P
    from functionalmf_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(n_dp, n_mp)
    for spec, shape in itertools.product(SPECS, SHAPES):
        want = tuple(jmesh._feasible_spec(jm, P(*spec), shape))
        got = feasible_spec({DP_AXIS: n_dp, MP_AXIS: n_mp}, spec, shape)
        assert got == want, (spec, shape)
        assert feasible_spec(_fake_mesh(n_dp, n_mp), spec, shape) == want


def _spec_pairs():
    """(name, JAX model, port model) built with the same arguments."""
    import jax.numpy as jnp
    import functionalmf_tpu as jf
    import functionalmf_tpu_torch as tf

    n, m, T, k = 5, 4, 8, 2
    C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
    RC = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

    def jll(Y, WV, W, V, row=None, col=None):
        return jnp.sum(WV)

    def tll(Y, WV, W, V, row=None, col=None):
        return WV.sum()

    def jnc(W, V, data):
        return jnp.sum(W) + jnp.sum(V)

    def tnc(W, V, data):
        return W.sum() + V.sum()

    common = dict(nembeds=k, tf_order=1, nchains=2, seed=0)
    cases = [
        ("constrained", jf.ConstrainedNonconjugateBayesianTensorFiltering,
         tf.ConstrainedNonconjugateBayesianTensorFiltering,
         (n, m, T), dict(Constraints=C), jll, tll),
        ("constrained_rc",
         jf.ConstrainedNonconjugateBayesianTensorFiltering,
         tf.ConstrainedNonconjugateBayesianTensorFiltering,
         (n, m, T), dict(Constraints=C, Row_constraints=RC), jll, tll),
        ("gaussian", jf.GaussianBayesianTensorFiltering,
         tf.GaussianBayesianTensorFiltering, (n, m, T), {}, None, None),
        ("gaussian_row", jf.GaussianBayesianTensorFiltering,
         tf.GaussianBayesianTensorFiltering, (n, m, T),
         dict(nu2_mode="row"), None, None),
        ("gaussian_hetero", jf.GaussianBayesianTensorFiltering,
         tf.GaussianBayesianTensorFiltering, (n, m, T),
         dict(nu2_true=np.full((n, m, T), 0.5)), None, None),
        ("binomial", jf.BinomialBayesianTensorFiltering,
         tf.BinomialBayesianTensorFiltering, (n, m, T), {}, None, None),
        ("negbinom", jf.NegativeBinomialBayesianTensorFiltering,
         tf.NegativeBinomialBayesianTensorFiltering, (n, m, T), {}, None,
         None),
        ("nonconjugate", jf.NonconjugateBayesianTensorFiltering,
         tf.NonconjugateBayesianTensorFiltering, (n, m, T), {}, jnc, tnc),
    ]
    for name, J, Tm, dims, kw, jl, tl in cases:
        jargs = dims + ((jl,) if jl is not None else ())
        targs = dims + ((tl,) if tl is not None else ())
        if "Constraints" in kw:
            kw = dict(kw)
            Cs = kw.pop("Constraints")
            jargs, targs = jargs + (Cs,), targs + (Cs,)
        yield (name, J(*jargs, **common, **kw),
               Tm(*targs, device="cpu", **common, **kw))


def test_state_partition_specs_match_jax():
    seen = []
    for name, jm, tm in _spec_pairs():
        want = {k: tuple(v) for k, v in jm.state_partition_specs().items()}
        got = tm.state_partition_specs()
        assert got == want, name
        assert set(tm.state) <= set(got), name
        assert tm._shard_specs() == got, name
        seen.append(name)
    assert len(seen) == 8


def test_device_must_be_the_mesh_device():
    from tests.torch_mesh_ranks import constrained_model
    with pytest.raises(ValueError, match="mesh device"):
        constrained_model("redblack", mesh=_fake_mesh(1, 1, device="cuda"))


def test_mesh_entry_points_check_their_arguments():
    from functionalmf_tpu_torch.parallel.mesh import init_distributed
    with pytest.raises(ValueError, match="backend"):
        init_distributed("localhost:1", 1, 0, backend="mpi")
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, 1, device_type="cpu")


def test_a_rank_keeps_its_block_of_every_entry():
    """Rank (0, 1) of a (1, 2) mesh keeps the second half of W's rows,
    of V's and Tau2's columns, and every chain of the rest."""
    from tests.torch_mesh_ranks import constrained_model
    whole, _ = constrained_model("redblack")
    part, _ = constrained_model("redblack", mesh=Mesh(
        1, 2, {DP_AXIS: 0, MP_AXIS: 1}, "cpu", {DP_AXIS: None,
                                               MP_AXIS: None}))
    # mp=2 divides 8 rows and 8 columns: rank (0, 1) holds the second half
    p = part._part
    assert (p.split_c, p.split_r, p.split_m) == (False, True, True)
    assert (p.r, p.m) == (slice(4, 8), slice(4, 8))
    for key, v in whole.state.items():
        spec = part._specs[key]
        idx = tuple(slice(4, 8) if s == MP_AXIS else slice(None)
                    for s in spec)
        assert torch.equal(part._state[key], v[idx]), key


BUILDER = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    import {module} as b
    b._BUILD_DIR = Path({build_dir!r})
    real = b.subprocess.run

    def counted(cmd, **kw):
        with open({log!r}, "a") as f:
            f.write("compile\\n")
        time.sleep(1.0)       # a slow compile, so that the two overlap
        return real(cmd, **kw)

    b.subprocess.run = counted
    {setup}
    print(b.build())
""")


@pytest.mark.parametrize("module", ["functionalmf_tpu_torch.utils.native",
                                    "functionalmf_tpu_torch.ops._build"])
def test_two_builders_at_once_build_once(module, tmp_path):
    """Two processes building into one fresh directory at once: the lock
    lets one compile and the other load its library. The CUDA build runs
    a stand-in nvcc here (a script that writes the output file)."""
    setup = ""
    if module.endswith("_build"):
        nvcc = tmp_path / "nvcc"
        nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                        "  shift\ndone\n")
        nvcc.chmod(0o755)
        setup = f"b._find_nvcc = lambda: {str(nvcc)!r}"
    log = tmp_path / "compiles.log"
    code = BUILDER.format(repo=REPO, module=module,
                          build_dir=str(tmp_path / "_build"), log=str(log),
                          setup=setup)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert log.read_text().count("compile") == 1


def test_mesh_kernel_cases_are_a_ranks_local_shapes():
    """ops/fused_ll_bench.py:mesh_cases, the shapes chip_smoke.py times
    for a (2, 2) mesh rank: at 20x20x228 the W update's R=20, C=4560, a
    colour phase's P=280 and a seq round's P=20 at Tb=8; on the CPU each
    case's kernel call is its plain version."""
    from functionalmf_tpu_torch.ops import fused_ll_bench as B
    Y, W, V, pol = B.synthetic_problem(n=20, m=20, T=228)
    cases = B.mesh_cases("cpu", Y, W, V, pol[3])
    got = [(c.name, c.shape.split(": ", 1)[1]) for c in cases]
    assert got == [("fused_row_ll", "R=20, C=4560"),
                   ("fused_row_ll_ep", "R=20, C=4560"),
                   ("fused_col_block_ll", "red-black phase: P=280, Tb=8"),
                   ("fused_col_block_ll_ep", "seq round: P=20, Tb=8")]
    for case in cases:
        assert torch.equal(case.kernel(), case.plain())
