#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from: for each seed, one
run of the cell (set-up, warm-up, a window of ``--seconds``) and the numbers
compared, of the program and of the controls: the plain reference computed
from inputs rounded to TF32 (the precision just below the configuration's
float32) and to bfloat16, in float32, in the program's place. All seeds run
in one process, so the kernels are built once. The benchmark's own runs
never run the controls.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from portbench import harness
    from portbench.reference import checks
    prog, ctrl = {}, {}
    for seed in args.seeds:
        t0 = time.time()
        r = harness.run_cell(args.workload, seed, args.seconds, 0,
                             args.device, t_start=t0,
                             control=tuple(checks.LOWP),
                             log=lambda m: None)
        line = dict(seed=seed, correct=r["correct"],
                    program={k: c["value"] for k, c in r["checks"].items()},
                    control=r["control_checks"],
                    metrics={k: m["value"] for k, m in r["metrics"].items()},
                    seconds=time.time() - t0)
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            prog[k] = max(prog.get(k, v), v)
        for name, numbers in line["control"].items():
            for k, v in numbers.items():
                low = ctrl.setdefault(name, {})
                low[k] = min(low.get(k, v), v)
        del r
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds,
                          program_max=prog, control_min=ctrl)))


if __name__ == "__main__":
    sys.exit(main())
