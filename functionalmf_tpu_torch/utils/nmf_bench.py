"""Time the dose-response app's host set-up with the native NNLS and with
its numpy version.

The set-up is what ``apps/doseresponse/fit.py:run`` times as
``nmf_seconds`` before its first sweep: the NMF baseline, the monotone NMF
(both under the 0.999 cap) and the warm start (the monotone NMF with the
row features, then EP). This script runs it on the app's own simulation at
full width (98x50x9x6, 20 features, k=5) with ``tensor_nmf``'s Gram NNLS
in the native library (``utils/native.py``) and in numpy
(``utils/nmf.py:_nnls_gram_one``), in turns (native, numpy, numpy,
native), and splits each run's seconds into the NNLS calls, the SLSQP
re-solves of the cap (``_capped_resolve``) and the rest. Host only: it
needs no card.

    python -m functionalmf_tpu_torch.utils.nmf_bench [--out FILE.json]
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from functionalmf_tpu_torch.utils import nmf

SIM = dict(k=5, n=100, m=50, t=9, r=6, p=20, seed=42)
ORDER = ("native", "numpy", "numpy", "native")


def dose_data(sim_kw):
    """The app's tensor and features from its simulation, through the
    CSVs it reads."""
    from functionalmf_tpu_torch.apps.doseresponse import fit, sim
    from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
        estimate_likelihood, read_csv_columns)
    with tempfile.TemporaryDirectory() as d:
        sim.write_csv(sim.simulate(**sim_kw), d)
        Y, _, cells, *_ = estimate_likelihood(
            read_csv_columns(os.path.join(d, "data.csv")), nbins=20,
            tensor_outcomes=True, verbose=False, device="cpu")
        X, _ = fit.read_features(os.path.join(d, "features.csv"), cells)
    return Y, X


def setup_seconds(Y, X, nnls, nembeds=5, seed=42):
    """One set-up as fit.run does it, with the Gram NNLS ``nnls``
    ("native" or "numpy"); returns its seconds: in all, in the NNLS calls
    and in the SLSQP re-solves."""
    from functionalmf_tpu_torch.apps.doseresponse import fit
    spent = dict(nnls_s=0.0, slsqp_s=0.0)
    native_batch, capped = nmf._nnls_gram_batch, nmf._capped_resolve

    def numpy_batch(G, F):
        return np.stack([nmf._nnls_gram_one(G[i], F[i])
                         for i in range(len(F))])

    def timed(fn, key):
        def wrapper(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    nmf._nnls_gram_batch = timed(
        native_batch if nnls == "native" else numpy_batch, "nnls_s")
    nmf._capped_resolve = timed(capped, "slsqp_s")
    try:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        nmf.tensor_nmf(Y, nembeds, max_entry=0.999, rng=rng)
        nmf.tensor_nmf(Y, nembeds, monotone=True, max_entry=0.999, rng=rng)
        fit.warm_start(Y, SimpleNamespace(nembeds=nembeds, seed=seed), X)
        total = time.perf_counter() - t0
    finally:
        nmf._nnls_gram_batch, nmf._capped_resolve = native_batch, capped
    return dict(total_s=total, **spent)


def run(sim_kw=SIM, order=ORDER):
    Y, X = dose_data(sim_kw)
    rows = []
    for nnls in order:
        r = dict(nnls=nnls, **setup_seconds(Y, X, nnls))
        rows.append(r)
        print(json.dumps(r), flush=True)
    return dict(shape=list(Y.shape), features=X.shape[1],
                host=platform.processor() or platform.machine(),
                cpus=os.cpu_count(), runs=rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the runs as JSON")
    args = p.parse_args(argv)
    out = run()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
