"""Where a (2, 2) mesh run leaves the unsharded run, and what the
constrained recipe's scale moves cost: a diagnostic, on the card unless
``--device cpu``.

    python mesh_drift.py drift [--model MODEL] [--sweeps N] [--device cpu]
                               [--shape mesh|test] [--threads N]
    python mesh_drift.py scale-moves [--sweeps N]
    python mesh_drift.py probe [--device cpu] [--threads N]
    python mesh_drift.py update-ms [--sweeps N]

It imports the ``chip_smoke.py`` and ``functionalmf_tpu_torch`` beside it
(and, at the tests' shape, ``tests/torch_mesh_ranks.py``): to drive
another checkout, copy the script into that checkout's root.

* ``drift``: on the card a model of ``chip_smoke.py``'s phase (b) at
  20x20x228, k=5, nchains 4 (``chip_smoke.mesh_path_model``); with
  ``--shape test`` (and always with ``--device cpu``) the same model at
  the mesh tests' shape (``tests/torch_mesh_ranks.py``: the recipe at
  8x8x6, the families at 6x4x12, k=2, nchains 2; on the CPU
  ``--threads`` torch threads in every process).
  ``--model``: the bench.py recipe (red-black, ngrid 100, scale moves),
  the Gaussian model with scalar, per-row (``gaussian_row``) or fixed
  heteroskedastic (``gaussian_hetero``) nu2, ``binomial`` or ``negbinom``
  (R sampled). It runs ``--sweeps`` sweeps on a (2, 2) mesh of four gloo
  ranks (sharing the card) and unsharded, the global state recorded after
  every step of every sweep (the prior updates, the W and V updates, the
  recipe's scale moves, the Gaussian nu2 draw, the Polya-Gamma draw,
  NegBinom's R moves; a rank's state all-gathered). Prints, as one JSON
  line, the first step whose state differs in any bit and, after each
  sweep, the W and V values beyond rtol = atol = 1e-3 of the unsharded
  run.
* ``scale-moves``: ms a call of the recipe's scale moves
  (``_interweave_scales``) and the full-tensor log-likelihoods they
  evaluate, counted, at 19x19x228 nchains 1 and 20x20x228 nchains 4, a
  synchronise around each call; then a sweep's count of those
  log-likelihoods timed with their per-column sums in one reduction and in
  the fixed orders (:func:`full_ll_ms`).
* ``probe``: ``chip_smoke.family_sum_probe`` (the conjugate families'
  sums, a (2, 2) rank's block against the same block of the whole call,
  each site in its old and its fixed form) at the mesh tests' shape
  (nchains 2, 6x4x12, k=2) and at phase (b)'s (nchains 4, 20x20x228,
  k=5), 50 random tensors each.
* ``update-ms``: the phases (``chip_smoke.where_time_goes``: ms a sweep,
  a synchronise around each) of the Gaussian model at 19x19x228 nchains 1
  and at 20x20x228 nchains 4, and of phase (b)'s NegBinom model, twice
  in turns: to time two trees, run it in each, in turns, inside one
  call.

The launch-invariance and sum-invariance probes are ``chip_smoke.py``'s
phase (c). Needs a CUDA card unless ``--device cpu``.
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

KEYS = ("W", "V", "sigma2", "lam2", "lam2_a", "Tau2", "nu2", "R")
PRIOR_STEPS = ("_update_sigma2", "_update_tau2", "_update_lam2")
FAMILY_STEPS = PRIOR_STEPS + ("_gaussian_update_W", "_gaussian_update_V")
STEPS = {
    "recipe": PRIOR_STEPS + ("_update_W_gass", "_update_V_gass",
                             "_interweave_scales"),
    "gaussian": ("_update_nu2",) + FAMILY_STEPS,
    "gaussian_row": ("_update_nu2",) + FAMILY_STEPS,
    "gaussian_hetero": FAMILY_STEPS,
    "binomial": ("_pg_update",) + FAMILY_STEPS,
    "negbinom": ("_update_R", "_pg_update") + FAMILY_STEPS,
}


def record_steps(model, steps, rec):
    """Append (step, global state as numpy) to ``rec`` after every call
    of each of ``steps`` (the scale moves' own sigma2 update included)."""
    for name in steps:
        real = getattr(model, name)

        def step(state, *a, _real=real, _name=name, **kw):
            out = _real(state, *a, **kw)
            st = out[0] if isinstance(out, tuple) else out   # _pg_update
            g = model._gather({k: st[k] for k in KEYS if k in st},
                              model._specs)
            rec.append((_name, {k: v.cpu().numpy() for k, v in g.items()}))
            return out
        setattr(model, name, step)


def build(what, dev, prob, mesh=None):
    """(model, data): phase (b)'s model with ``prob`` (mesh_problem()),
    else the mesh tests' model."""
    if prob is not None:
        return cs.mesh_path_model("redblack" if what == "recipe" else what,
                                  dev, prob, mesh)
    from tests.torch_mesh_ranks import constrained_model, family_model
    return (constrained_model("redblack", mesh=mesh, device=dev)
            if what == "recipe" else family_model(what, mesh=mesh,
                                                  device=dev))


def model_run(what, dev, prob, sweeps, mesh=None):
    model, Y = build(what, dev, prob, mesh)
    rec = []
    record_steps(model, STEPS[what], rec)
    model.run_gibbs(Y, nburn=sweeps - 1, nthin=1, nsamples=1, verbose=False)
    return rec


def drift_rank(rank, world, url, out, what, sweeps, prob, dev_type,
               threads):
    try:
        from functionalmf_tpu_torch.parallel.mesh import (init_distributed,
                                                          make_mesh)
        if dev_type == "cpu":
            torch.set_num_threads(threads)
        init_distributed(url, world, rank, backend="gloo", timeout_s=600)
        mesh = make_mesh(2, 2, device_type=dev_type)
        rec = model_run(what, mesh.device, prob, sweeps, mesh)
        out.put((rank, "ok", rec if rank == 0 else None))
    except BaseException:                                   # noqa: BLE001
        import traceback
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def far(a, b):
    return int((np.abs(a - b) > 1e-3 + 1e-3 * np.abs(b)).sum())


def compare(mesh_rec, rec, last_step):
    """The first record that differs in any bit, and each sweep's W and V
    against the unsharded run (a sweep ends at ``last_step``)."""
    if [n for n, _ in mesh_rec] != [n for n, _ in rec]:
        raise RuntimeError("the mesh and the unsharded run took other steps")
    first, sweep, per_sweep = None, 1, []
    for i, ((name, a), (_, b)) in enumerate(zip(mesh_rec, rec)):
        diff = [k for k in a if not np.array_equal(a[k], b[k])]
        if diff and first is None:
            first = dict(sweep=sweep, step=name, record=i, keys=diff,
                         values_differ={k: int((a[k] != b[k]).sum())
                                        for k in diff},
                         max_abs={k: float(np.abs(a[k] - b[k]).max())
                                  for k in diff})
        if name == last_step:
            per_sweep.append(dict(
                sweep=sweep, bit_equal=not diff, W_beyond=far(a["W"], b["W"]),
                V_beyond=far(a["V"], b["V"]),
                max_abs_W=float(np.abs(a["W"] - b["W"]).max()),
                max_abs_V=float(np.abs(a["V"] - b["V"]).max())))
            sweep += 1
    return first, per_sweep


def drift(args):
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    prob = cs.mesh_problem() if args.shape == "mesh" else None
    import queue
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    got = {}
    with tempfile.TemporaryDirectory() as rdv:
        url = "file://" + rdv + "/rendezvous"
        procs = [ctx.Process(target=drift_rank, args=(
            r, 4, url, q, args.model, args.sweeps, prob, dev.type,
            args.threads)) for r in range(4)]
        for p in procs:
            p.start()
        try:
            while len(got) < 4:
                try:
                    r, status, val = q.get(timeout=1.0)
                except queue.Empty:
                    if time.perf_counter() - t0 > 900 or any(
                            p.exitcode not in (None, 0) for p in procs):
                        raise RuntimeError("a rank died or timed out")
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {r}:\n{val}")
                got[r] = val
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    t_mesh = time.perf_counter() - t0
    first, per_sweep = compare(
        got[0], model_run(args.model, dev, prob, args.sweeps),
        STEPS[args.model][-1])
    print(json.dumps(dict(
        tree=os.path.dirname(os.path.abspath(__file__)), model=args.model,
        device=args.device, shape=[got[0][0][1]["W"].shape[1]]
        + list(got[0][0][1]["V"].shape[1:3]), sweeps=args.sweeps,
        mesh_seconds=round(t_mesh, 1), first_difference=first,
        per_sweep=per_sweep)), flush=True)


def scale_moves(args):
    from functionalmf_tpu_torch.ops import fused_ll as F
    dev = torch.device("cuda:0")
    Y19, Con, W0, V0, _ = cs.bench_data()
    prob = cs.mesh_problem()
    for tag, Y, Con_, W0_, V0_, nch in (
            ("19x19x228 nchains=1", Y19, Con, W0, V0, 1),
            ("20x20x228 nchains=4", prob["Y"], prob["Con"], prob["W0"],
             prob["V0"], 4)):
        model = cs.recipe_model(dev, Y.shape, Con_, W0_, V0_, nchains=nch)
        cell, calls, ms = model.loglikelihood_cellfn, [0], []

        def counted(y, tau):
            calls[0] += 1
            return cell(y, tau)
        real = model._interweave_scales

        def timed(state, y, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(state, y, gen)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            return out
        model.run_gibbs(Y, nburn=1, nthin=1, nsamples=1, verbose=False)
        model.loglikelihood_cellfn = F.CellFn(cell.name, counted)
        model._interweave_scales = timed
        model.run_gibbs(Y, nburn=args.sweeps - 1, nthin=1, nsamples=1,
                        verbose=False)
        print(json.dumps(dict(
            recipe=tag, sweeps=args.sweeps,
            scale_moves_ms=float(np.mean(ms)),
            scale_moves_ms_median=float(np.median(ms)),
            full_ll_calls_a_sweep=calls[0] / args.sweeps,
            full_ll_ms=full_ll_ms(model, Y, cell, round(calls[0] /
                                                        args.sweeps)))),
              flush=True)


def full_ll_ms(model, Y, cell, calls, reps=5):
    """ms of ``calls`` evaluations of the scale moves' full-tensor
    log-likelihood at the model's state (unsharded), its per-column sums
    in one reduction, in ``_fixed_sum``'s order and in ``_window_sum``'s,
    in turns (each form, then each in reverse order), ``reps`` times each,
    a synchronise around each batch of calls; the median a batch."""
    from functionalmf_tpu_torch.models import base
    st = model._state
    W = st["W"] * model._wmask
    tau = torch.einsum("cnk,cmtk->cnmt", W, st["V"])
    y32 = model._f32(model._rows_cols(model.prepare_data(Y))[1])[None]
    forms = {"one_reduction": lambda: cell(y32, tau).sum((1, 3)).sum(1),
             "_fixed_sum": lambda: base._fixed_sum(cell(y32, tau), (1, 3))[
                 :, 0, :, 0].sum(1),
             "_window_sum": lambda: base._window_sum(
                 cell(y32, tau), (1, 3))[:, 0, :, 0].sum(1)}
    times = {k: [] for k in forms}
    for name in list(forms) + list(forms)[::-1]:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                forms[name]()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {k: float(np.median(v)) for k, v in times.items()}


def probe(args):
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    for tag, shape in (("nchains 2, 6x4x12, k=2", (2, 6, 4, 12, 2)),
                       ("nchains 4, 20x20x228, k=5", (4, 20, 20, 228, 5))):
        print(json.dumps(dict(
            probe=tag, device=args.device, threads=torch.get_num_threads(),
            draws=50, differ=cs.family_sum_probe(dev, shape, 50))),
            flush=True)


def update_ms(args):
    from functionalmf_tpu_torch import GaussianBayesianTensorFiltering
    dev = torch.device("cuda:0")
    prob = cs.mesh_problem()
    shape = (cs.NROWS, cs.NCOLS, cs.NDEPTH)
    runs = {"gaussian 19x19x228 nchains=1": lambda: (
        GaussianBayesianTensorFiltering(
            *shape, device=dev, nembeds=cs.NEMBEDS, tf_order=2,
            sigma2_init=0.5, lam2_init=0.1, nu2_init=1, seed=0, nchains=1),
        cs.gaussian_data()),
        "gaussian 20x20x228 nchains=4": lambda: cs.mesh_path_model(
            "gaussian", dev, prob),
        "negbinom 20x20x228 nchains=4": lambda: cs.mesh_path_model(
            "negbinom", dev, prob)}
    for rep in range(2):
        for tag, make in runs.items():
            model, Y = make()
            ms = cs.where_time_goes(tag, model, Y, cs.BANDED_SWEEP,
                                    sweeps=args.sweeps, warm=5)
            print(json.dumps(dict(
                tree=os.path.dirname(os.path.abspath(__file__)), rep=rep,
                model=tag, ms=ms)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("drift", "scale-moves", "probe",
                                     "update-ms"))
    ap.add_argument("--model", choices=tuple(STEPS), default="recipe")
    ap.add_argument("--sweeps", type=int, default=12)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="drift and probe only; drift on the cpu runs the "
                    "mesh tests' shape")
    ap.add_argument("--shape", choices=("mesh", "test"), default=None,
                    help="drift's shape: phase (b)'s (the card's default) "
                    "or the mesh tests' (the CPU's only)")
    ap.add_argument("--threads", type=int, default=1,
                    help="torch threads a process on the CPU")
    args = ap.parse_args(argv)
    args.shape = args.shape or ("mesh" if args.device == "cuda" else "test")
    if args.device == "cpu":
        if args.shape != "test":
            raise SystemExit("mesh_drift: the CPU runs the tests' shape")
        if args.what not in ("drift", "probe"):
            raise SystemExit("mesh_drift: only drift and probe run on the "
                             "CPU")
        torch.set_num_threads(args.threads)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("mesh_drift: needs a CUDA card")
        from functionalmf_tpu_torch._runtime import require_full_f32
        require_full_f32()
    {"drift": drift, "scale-moves": scale_moves, "probe": probe,
     "update-ms": update_ms}[args.what](args)


if __name__ == "__main__":
    main()
