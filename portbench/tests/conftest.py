"""The benchmark's own tests: run from the repository's root with
``python -m pytest portbench/tests -q``. Tests that need a card are marked
``cuda`` and skip without one."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "tiny-poisson": dict(config="politics-poisson-btf",
                         sizes=dict(nrows=6, ncols=5, ndepth=24, nembeds=2),
                         traffic=dict(nchains=3, nthin=2,
                                      v_schedule="redblack", ep=None,
                                      sweeps_per_second=40)),
    "tiny-poisson-seq-ep": dict(config="politics-poisson-btf",
                                sizes=dict(nrows=6, ncols=5, ndepth=24,
                                           nembeds=2),
                                traffic=dict(nchains=2, nthin=1,
                                             v_schedule="seq",
                                             ep=dict(sigma_offset=0.5),
                                             sweeps_per_second=20)),
    "tiny-gamma": dict(config="doseresponse-gamma-btf",
                       sizes=dict(cell_lines=8, drugs=5, features=4,
                                  nembeds=2),
                       traffic=dict(nchains=2, nthin=1, v_schedule="seq",
                                    sweeps_per_second=10)),
}


def add_tiny_cells(root):
    """Add a tiny configuration, traffic and cell of each family to the
    benchmark copy at ``root``, as new files only."""
    for cell, spec in TINY.items():
        cfg = json.loads((root / "configs" / f"{spec['config']}.json")
                         .read_text())
        cfg.update(spec["sizes"])
        (root / "configs" / f"{cell}.json").write_text(json.dumps(cfg))
        (root / "traffic" / f"{cell}.json").write_text(
            json.dumps(spec["traffic"]))
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(dict(
            config=cell, traffic=cell, chips=1, why="a test's tiny cell")))


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory):
    """A copy of portbench/ with the tiny cells added."""
    root = tmp_path_factory.mktemp("bench") / "portbench"
    shutil.copytree(ROOT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(root)
    return root


@pytest.fixture
def run_tiny(bench_copy):
    """run_tiny(cell, seed=1, seconds=0.5, trace=0) on the CPU."""
    import torch
    from portbench import harness
    torch.set_num_threads(2)

    def run(cell, seed=1, seconds=0.5, trace=0, **kw):
        return harness.run_cell(cell, seed, seconds, trace, "cpu",
                                t_start=None, log=lambda m: None,
                                root=bench_copy, **kw)
    return run
