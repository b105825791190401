"""No file of the benchmark imports the JAX stack or the JAX package (top-
level names compared whole: the port's name begins with the JAX
package's); the reference imports nothing of the program; nothing reads
the JAX package's benchmark folder."""
import ast
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parents[1]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_foreign_modules_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax", "functionalmf_tpu",
            "functionalmf_tpu.ops", "functionalmf_tpu_torch",
            "functionalmf_tpu_torch.models", "jaxtyping", "flaxen", "numpy"]
    assert harness.foreign_modules(mods) == [
        "flax", "functionalmf_tpu", "functionalmf_tpu.ops", "jax",
        "jax.numpy", "jaxlib.xla"]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FOREIGN, (f, name)


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").glob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] != "functionalmf_tpu_torch", (f, name)


def test_nothing_reads_the_jax_benchmark_folder():
    for f in sorted(HERE.rglob("*.py")):
        if f.parent.name == "tests":
            continue
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.startswith(("bench/", "bench\\")), f
