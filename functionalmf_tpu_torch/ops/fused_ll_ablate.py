"""Where the fused kernels' device time goes: every kernel at the paths'
shapes, built whole and with one part taken out.

    python -m functionalmf_tpu_torch.ops.fused_ll_ablate [--out FILE]

Each variant is ``csrc/fused_ll.cu`` with one edit, built into its own
library in ``_build/``:

* ``whole``: the kernels as they are;
* ``one_cell``: each warp computes one cell of its range (the candidate-
  cell loop cut, the candidates still loaded);
* ``no_copy``: no chunk is copied to shared memory;
* ``no_reduce``: rank 0 writes its own block's sums (no cluster
  reduction).

The cut variants' outputs are wrong by design: only their device time
(``fused_ll_bench.device_us``) is read. The whole build is checked
against the plain versions first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from functionalmf_tpu_torch.ops import _build
from functionalmf_tpu_torch.ops import fused_ll_bench as B

__all__ = ["variants", "main"]


def _cut(src, old, new):
    if old not in src:
        raise RuntimeError(f"fused_ll_ablate: the kernel source no longer "
                           f"holds {old.strip()[:60]!r}")
    return src.replace(old, new)


def variants(src):
    """name -> source of each variant."""
    one_cell = _cut(
        src, "const int ce = (int)((long long)(part_i + 1) * n / wps);",
        "const int ce = min((int)((long long)(part_i + 1) * n / wps), "
        "cb + 1);")
    no_copy = _cut(src, "    if (nq > 0) map.fetch(0, stage0, L, !direct);\n",
                   "")
    no_copy = _cut(no_copy, "        map.fetch(q + 1, stage0 + ((q + 1) & 1) "
                   "* L.stage, L, true);\n", "        ;\n")
    no_copy = _cut(no_copy, "  map.fetch_fixed(fixed);\n", "")
    head = "    cluster.sync();\n    if (cluster.block_rank() == 0 && " \
           "threadIdx.x < gp) {"
    tail = "    cluster.sync();   // part is read"
    a = src.index(head)
    b = src.index("\n", src.index(tail)) + 1
    no_reduce = (src[:a] + "    if (cluster.block_rank() == 0 && "
                 "threadIdx.x < gp) map.out()[g0 + threadIdx.x] = "
                 "part[threadIdx.x];\n" + src[b:])
    return dict(whole=src, one_cell=one_cell, no_copy=no_copy,
                no_reduce=no_reduce)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the times as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_ll_ablate: needs a CUDA device")
    from functionalmf_tpu_torch._runtime import require_full_f32
    require_full_f32()
    dev = torch.device("cuda:0")
    src = (_build._SRC_DIR / "fused_ll.cu").read_text()
    build_dir = _build._BUILD_DIR
    build_dir.mkdir(exist_ok=True)
    libs = {}
    for name, text in variants(src).items():
        path = build_dir / f"fused_ll_{name}.cu"
        path.write_text(text)
        libs[name] = _build.declare(ctypes.CDLL(str(
            _build.build([path], name=f"fmf_{name}"))))
    Y, W, V, pol = B.synthetic_problem()
    cases = B.path_cases(dev, Y, W, V, pol)
    _build._lib = libs["whole"]
    for case in cases:
        B.compare(case.kernel(), case.plain())
    rows = []
    for case in cases:
        row = dict(name=case.name, shape=case.shape)
        for name, lib in libs.items():
            _build._lib = lib
            row[name] = B.device_us(case.kernel)[0]
        print(" ".join([f"{case.name} ({case.shape}):"] +
                       [f"{n}={row[n]:.2f}" for n in libs]), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), rows=rows), indent=1))


if __name__ == "__main__":
    main()
