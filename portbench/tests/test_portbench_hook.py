"""The benchmark's traced callback and capture wrappers change nothing
the chain draws: a run with them equals a run without them, bit for
bit."""
import numpy as np
import torch

from portbench import harness


def test_hook_leaves_the_draws_unchanged(bench_copy):
    torch.set_num_threads(2)
    wl = harness.load_workload("tiny-poisson", bench_copy)
    fam = harness.family(wl["config_data"], bench_copy)
    runs = []
    for with_hook in (False, True):
        cell = fam.build(wl["config_data"], wl["traffic_data"], 11,
                         torch.device("cpu"))
        rec = harness.Recorder(11, "cpu")
        restore = cell.install(rec)
        try:
            kw = dict(traced_callback=rec.hook) if with_hook else {}
            if with_hook:
                rec.start_marks(6)
                rec.choose_captures(6, cell.nchains)
            runs.append(cell.model.run_gibbs(cell.data, nburn=2, nthin=2,
                                             nsamples=2, verbose=False,
                                             key=123, **kw))
        finally:
            restore()
    a, b = runs
    kinds = {c["kind"] for c in rec.captures}    # the hooked run kept
    assert {"before", "after", "scales_in", "gass", "slice"} <= kinds
    for key in ("W", "V", "sigma2", "lam2", "Tau2"):
        assert np.array_equal(a[key], b[key]), key
