"""The port imports torch, numpy and scipy, never jax or the JAX package."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "functionalmf_tpu_torch",
    "functionalmf_tpu_torch._runtime",
    "functionalmf_tpu_torch.apps.doseresponse.empirical_bayes",
    "functionalmf_tpu_torch.apps.doseresponse.feature_importance",
    "functionalmf_tpu_torch.apps.doseresponse.fit",
    "functionalmf_tpu_torch.apps.doseresponse.logistic",
    "functionalmf_tpu_torch.apps.doseresponse.plots",
    "functionalmf_tpu_torch.apps.doseresponse.results",
    "functionalmf_tpu_torch.apps.doseresponse.select_btf",
    "functionalmf_tpu_torch.apps.doseresponse.sim",
    "functionalmf_tpu_torch.apps.flutrends.benchmark",
    "functionalmf_tpu_torch.apps.flutrends.bnp_covreg",
    "functionalmf_tpu_torch.apps.flutrends.create_datasets",
    "functionalmf_tpu_torch.apps.politics.benchmark",
    "functionalmf_tpu_torch.apps.politics.create_datasets",
    "functionalmf_tpu_torch.examples.anchors",
    "functionalmf_tpu_torch.examples.binomial_tensor_filtering",
    "functionalmf_tpu_torch.examples.gaussian_tensor_filtering",
    "functionalmf_tpu_torch.examples.negbinom_tensor_filtering",
    "functionalmf_tpu_torch.examples.poisson_tensor_filtering",
    "functionalmf_tpu_torch.examples.recipe",
    "functionalmf_tpu_torch.interop",
    "functionalmf_tpu_torch.models.base",
    "functionalmf_tpu_torch.models.binomial",
    "functionalmf_tpu_torch.models.constrained",
    "functionalmf_tpu_torch.models.gaussian",
    "functionalmf_tpu_torch.models.negbinom",
    "functionalmf_tpu_torch.models.nonconjugate",
    "functionalmf_tpu_torch.models.pgds",
    "functionalmf_tpu_torch.ops._build",
    "functionalmf_tpu_torch.ops.banded",
    "functionalmf_tpu_torch.ops.crt",
    "functionalmf_tpu_torch.ops.fused_ll",
    "functionalmf_tpu_torch.ops.fused_ll_bench",
    "functionalmf_tpu_torch.ops.gamma",
    "functionalmf_tpu_torch.ops.mvn",
    "functionalmf_tpu_torch.ops.penalty",
    "functionalmf_tpu_torch.ops.polyagamma",
    "functionalmf_tpu_torch.parallel",
    "functionalmf_tpu_torch.parallel.mesh",
    "functionalmf_tpu_torch.pgds",
    "functionalmf_tpu_torch.samplers.conjugate",
    "functionalmf_tpu_torch.samplers.ess",
    "functionalmf_tpu_torch.samplers.gass",
    "functionalmf_tpu_torch.samplers.horseshoe",
    "functionalmf_tpu_torch.samplers.slice1d",
    "functionalmf_tpu_torch.utils",
    "functionalmf_tpu_torch.utils.binary_mf",
    "functionalmf_tpu_torch.utils.diagnostics",
    "functionalmf_tpu_torch.utils.ep",
    "functionalmf_tpu_torch.utils.metrics",
    "functionalmf_tpu_torch.utils.native",
    "functionalmf_tpu_torch.utils.nmf",
    "functionalmf_tpu_torch.utils.nmf_bench",
    "functionalmf_tpu_torch.utils.pav",
    "functionalmf_tpu_torch.utils.telemetry",
]


def test_module_list_covers_the_package():
    """Every module of the port is in MODULES (the kernel ablation script
    apart, which builds kernels when it runs)."""
    root = os.path.join(REPO, "functionalmf_tpu_torch")
    found = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), REPO)[:-3]
                name = rel.replace(os.sep, ".")
                found.add(name[:-9] if name.endswith(".__init__") else name)
    listed = set(MODULES)
    missing = {m for m in found - listed
               if not any(p.startswith(m + ".") for p in listed)}
    assert missing <= {"functionalmf_tpu_torch.ops.fused_ll_ablate"}, missing
    assert listed <= found, listed - found


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'functionalmf_tpu.')) or "
            "m == 'functionalmf_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_exports_the_jax_mesh_surface():
    """``functionalmf_tpu_torch.parallel`` imports no jax (the test above,
    which imports it) and exports a counterpart of every name of the JAX
    package's ``parallel/mesh.py`` (its ``parallel/__init__`` exports
    nothing): the same name where a reader looks for it, the torch
    counterpart where JAX's names a JAX type."""
    import functionalmf_tpu_torch.parallel as tp
    from functionalmf_tpu.parallel import mesh as jmesh
    counterpart = {"state_shardings": "state_specs",
                   "specs_to_shardings": "state_specs",
                   "make_global_array": "gather_state"}
    for name in jmesh.__all__:
        assert counterpart.get(name, name) in tp.__all__, name
    for name in tp.__all__:
        assert hasattr(tp, name), name
    assert (tp.DP_AXIS, tp.MP_AXIS) == (jmesh.DP_AXIS, jmesh.MP_AXIS)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port on a card; importing it (as its
    __main__ guard allows) must load no jax either."""
    code = ("import sys\nimport chip_smoke\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'functionalmf_tpu' not in sys.modules\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_top_level_exports_the_jax_public_surface():
    """Every name of the JAX package's ``__all__`` is exported by the port
    (``gass`` and ``elliptical_slice`` among them), and the two samplers
    take the JAX call forms' parameters in their order, a generator in
    the key's place."""
    import inspect

    import functionalmf_tpu as jpkg
    import functionalmf_tpu_torch as tpkg
    for name in jpkg.__all__:
        assert name in tpkg.__all__ and hasattr(tpkg, name), name
    for name in ("gass", "elliptical_slice"):
        jp = list(inspect.signature(getattr(jpkg, name)).parameters)
        tp = list(inspect.signature(getattr(tpkg, name)).parameters)
        assert jp[0] == "key" and tp[0] == "gen", name
        assert tp[1:len(jp)] == jp[1:], (name, jp, tp)


def test_mesh_drift_imports_no_jax():
    """mesh_drift.py, the card's step-by-step mesh comparison, loads no
    jax either."""
    code = ("import sys\nsys.argv = ['mesh_drift.py']\nimport mesh_drift\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'functionalmf_tpu' not in sys.modules\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
