"""The port imports torch, numpy and scipy, never jax or the JAX package."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "functionalmf_tpu_torch",
    "functionalmf_tpu_torch._runtime",
    "functionalmf_tpu_torch.apps.politics.benchmark",
    "functionalmf_tpu_torch.interop",
    "functionalmf_tpu_torch.models.base",
    "functionalmf_tpu_torch.models.constrained",
    "functionalmf_tpu_torch.ops._build",
    "functionalmf_tpu_torch.ops.fused_ll",
    "functionalmf_tpu_torch.ops.mvn",
    "functionalmf_tpu_torch.ops.penalty",
    "functionalmf_tpu_torch.samplers.conjugate",
    "functionalmf_tpu_torch.samplers.gass",
    "functionalmf_tpu_torch.samplers.horseshoe",
    "functionalmf_tpu_torch.samplers.slice1d",
    "functionalmf_tpu_torch.utils.diagnostics",
    "functionalmf_tpu_torch.utils.ep",
    "functionalmf_tpu_torch.utils.nmf",
    "functionalmf_tpu_torch.utils.pav",
]


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
