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
    "functionalmf_tpu_torch.apps.politics.benchmark",
    "functionalmf_tpu_torch.examples.binomial_tensor_filtering",
    "functionalmf_tpu_torch.examples.gaussian_tensor_filtering",
    "functionalmf_tpu_torch.examples.negbinom_tensor_filtering",
    "functionalmf_tpu_torch.examples.poisson_tensor_filtering",
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
    "functionalmf_tpu_torch.pgds",
    "functionalmf_tpu_torch.samplers.conjugate",
    "functionalmf_tpu_torch.samplers.ess",
    "functionalmf_tpu_torch.samplers.gass",
    "functionalmf_tpu_torch.samplers.horseshoe",
    "functionalmf_tpu_torch.samplers.slice1d",
    "functionalmf_tpu_torch.utils.diagnostics",
    "functionalmf_tpu_torch.utils.ep",
    "functionalmf_tpu_torch.utils.metrics",
    "functionalmf_tpu_torch.utils.nmf",
    "functionalmf_tpu_torch.utils.pav",
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


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port on a card; importing it (as its
    __main__ guard allows) must load no jax either."""
    code = ("import sys\nimport chip_smoke\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'functionalmf_tpu' not in sys.modules\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
