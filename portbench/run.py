#!/usr/bin/env python3
"""portbench: the benchmark of functionalmf_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the package. It makes every
input from ``--seed``, builds the cell's model, warms up, measures one
``run_gibbs`` call of about ``--seconds`` seconds, checks what that call
computed against the plain reference under ``portbench/reference/``, and
prints one JSON line last. Without a CUDA card (or with fewer than the
cell asks for) it exits with 2 and prints no result.
"""
import time

_T0 = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench import harness

    def log(msg):
        print(msg, flush=True)

    start = harness.process_start() or _T0
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  args.trace, "cuda", t_start=start, log=log)
    except harness.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.foreign_modules(sys.modules)
    if found:
        print("portbench: the run loaded the JAX stack or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
