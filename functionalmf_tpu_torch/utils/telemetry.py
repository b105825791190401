"""The run record: where one ``run_gibbs`` call spent its time, on the
host's clock and on the device stream's, and where it waited for the
device.

Every call of ``run_gibbs`` on a model whose ``trace_runs`` is true (the
default, a class attribute beside ``max_sweeps_per_call``) keeps one
record, a plain JSON-able dict, as ``model.last_run``; ``recent()``
returns the last ``KEEP`` records of the process (under a mesh each rank
keeps its own). With ``trace_runs = False`` every span and counter is a
no-op that returns one shared null context, and neither is touched.

The spans nest so; a layer's self time is its span less its children's::

    call  > head | sweep ... | flush (mid-run) | tail
    sweep > r_moves | pg_draw | prior | w_update | v_update | scale_moves
            | hook
    w_update, v_update > blackbox_ll
    v_update > v_bands | banded_sample
    tail  > flush | report

* ``head`` (host clock): from the call's entry to its first sweep's first
  launch: the start check (the constrained models' feasibility check),
  ``prepare_data`` and ``_make_sweep``.
* ``sweep`` and its phases (stream clock): an event recorded on the
  model's stream at every phase boundary and never waited on. The phases
  tile their sweep and each sweep starts where the one before ended, so
  the phases that ran add up to the sweep. ``r_moves``: NegBinom's
  Metropolis moves on its dispersion R; ``pg_draw``: the Polya-Gamma
  models' draw of omega (with NegBinom's pseudo-counts); ``prior``: the
  re-draws before W (sigma2, Tau2, lam2, and the Gaussian model's nu2);
  ``w_update``, ``v_update``: the factor updates with their non-finite
  guard; ``scale_moves``: the constrained models' interweaving; ``hook``:
  the hook or host callback and the draw's snapshot. ``blackbox_ll``:
  each lifted call of the user's likelihood in the W and V updates;
  ``v_bands``, ``banded_sample``: the conjugate V update's band build
  (the likelihood Gram and the prior's bands) and its block-banded draw.
  The events are resolved into sums at each flush, once the draws' copy
  has waited for the stream; the record keeps no event past a flush. On
  the CPU the same spans read the host clock.
* ``tail`` (host clock): from the moment the stream has finished the last
  sweep (the one wait the record adds a call, on that sweep's last event:
  the draws' copy waits for the same work) to the return: the last
  ``flush`` and the ``report`` (the results' layout, the health counters,
  R-hat).
* ``flush`` (host clock): the collected draws stacked, gathered and
  copied to the host (and a checkpoint written); a mid-run flush (every
  ``max_sweeps_per_call`` sweeps) lies between two sweeps.

Counters (``count(site)``): each host read of a device value (a host sync
on the card) by site, ``sync:cholesky_psd``, ``sync:gass_shrink``,
``sync:ess``, ``sync:banded_chol``, ``sync:block_starts``, and
``cholesky_retries`` (the jitter ladder of ``cholesky_psd`` ran), kept by
where they happened: ``head``, ``sweep``, ``flush`` (mid-run) or ``tail``.

Inside the call's own ``profile_dir`` profile, and only there, every span
also opens ``torch.profiler.record_function("fmf:<span>")``, so that the
trace shows what the host was doing beside the kernels.

The record::

    sweeps      sweeps the call ran
    nchains     chains of the model
    host_ms     {head, tail, flush, report}: ms a call
    stream_ms   {sweep, and each phase or span that ran}: ms summed over
                the call's sweeps
    counts      {head|sweep|flush|tail: {site: n},
                 launches: {kernel: hand-written kernel launches of the
                            call: ``fused_ll``'s and ``polyagamma``'s}}
    d2h_bytes   bytes of the draws copied to the host
"""
from __future__ import annotations

import collections
import time

import torch

from functionalmf_tpu_torch.ops import fused_ll, polyagamma

__all__ = ["KEEP", "record", "recent", "count", "phase", "span", "Run",
           "launch_counts"]

KEEP = 8
_recent = collections.deque(maxlen=KEEP)
_current = None            # the run under way in this process


def launch_counts():
    """Every hand-written kernel's launches so far in this process."""
    return {**fused_ll.launch_counts, **polyagamma.launch_counts}


def recent():
    """The last ``KEEP`` run records of this process, oldest first."""
    return list(_recent)


def count(site, n=1):
    """Count ``n`` at ``site`` in the run under way (none: nothing)."""
    if _current is not None:
        _current.count(site, n)


def phase(name):
    """A phase of the sweep under way, tiled with the one before it."""
    return NULL if _current is None else _current.phase(name)


def span(name):
    """A stream-clock span of its own inside a phase."""
    return NULL if _current is None else _current.span(name)


def record(model):
    """The run record of one ``run_gibbs`` call of ``model``: a context
    that opens the head at entry and, when the call returns, sets
    ``model.last_run`` and appends to ``recent()``. ``NULL`` where
    ``model.trace_runs`` is false."""
    return Run(model) if getattr(model, "trace_runs", True) else NULL


class _Null:
    """Records nothing: the context of every span and counter of a model
    with ``trace_runs = False``, and of code outside a run."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sweep(self):
        return self

    def phase(self, name):
        return self

    def span(self, name):
        return self

    def host(self, name):
        return self

    def count(self, site, n=1):
        pass

    def d2h(self, nbytes):
        pass

    def begin_tail(self):
        pass

    def set_labels(self, on):
        pass


NULL = _Null()


def _label(run, name):
    """An open ``record_function`` range inside the run's own profile."""
    if not run.labels:
        return None
    rf = torch.profiler.record_function("fmf:" + name)
    rf.__enter__()
    return rf


def _close(rf):
    if rf is not None:
        rf.__exit__(None, None, None)


class Run:
    """One call's record while it runs (see the module docstring)."""

    def __init__(self, model):
        self.model = model
        self.cuda = model.device.type == "cuda"
        self._stream = (torch.cuda.current_stream(model.device)
                        if self.cuda else None)
        self.labels = False
        self.where = "head"
        self.sweeps = 0
        self.host_ms = dict(head=0.0, tail=0.0, flush=0.0, report=0.0)
        self.stream_ms = {"sweep": 0.0}
        self.counts = {}
        self.d2h_bytes = 0
        self._open = []            # (name, start, end) not yet resolved
        self._edge = None          # the last phase boundary
        self._first = None         # the sweep's first boundary
        self._last = None          # the stamp taken last
        self._rf = None            # the head's or tail's label
        self._t_tail = None
        self._launches0 = launch_counts()

    # -- the call ----------------------------------------------------------
    def __enter__(self):
        global _current
        self._prev, _current = _current, self
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _current
        _current = self._prev
        if exc_type is not None:
            return False
        if self.where == "head":
            self._end_head()
        if self._t_tail is None:
            self.begin_tail()
        _close(self._rf)
        self._rf = None
        self.host_ms["tail"] = 1e3 * (time.perf_counter() - self._t_tail)
        rec = self.as_dict()
        self.model.last_run = rec
        _recent.append(rec)
        return False

    def _end_head(self):
        self.host_ms["head"] = 1e3 * (time.perf_counter() - self._t0)
        _close(self._rf)
        self._rf = None

    def begin_tail(self):
        """The tail starts once the stream has run the last sweep."""
        if self.cuda and self._edge is not None:
            self._edge.synchronize()
        self._t_tail = time.perf_counter()
        self.where = "tail"
        _close(self._rf)
        self._rf = _label(self, "tail")

    def set_labels(self, on):
        """Label every span for the call's own profiler (on while it
        runs); the head's or tail's label closes with it."""
        if on and not self.labels:
            self.labels = True
            if self.where in ("head", "tail"):
                self._rf = _label(self, self.where)
        elif not on and self.labels:
            _close(self._rf)
            self._rf = None
            self.labels = False

    # -- spans and counters ------------------------------------------------
    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
        else:
            ev = time.perf_counter()
        self._last = ev
        return ev

    def sweep(self):
        return _Sweep(self)

    def phase(self, name):
        return _Phase(self, name)

    def span(self, name):
        return _Span(self, name)

    def host(self, name):
        return _Host(self, name)

    def count(self, site, n=1):
        where = self.counts.setdefault(self.where, {})
        where[site] = where.get(site, 0) + n

    def d2h(self, nbytes):
        self.d2h_bytes += int(nbytes)

    def resolve(self):
        """The stream-clock spans into their sums; the next sweep starts a
        new boundary."""
        self._edge = None
        if not self._open:
            return
        if self.cuda:
            self._last.synchronize()
        for name, a, b in self._open:
            ms = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
            self.stream_ms[name] = self.stream_ms.get(name, 0.0) + ms
        self._open.clear()

    def as_dict(self):
        counts = {k: dict(v) for k, v in self.counts.items()}
        counts["launches"] = {k: v - self._launches0.get(k, 0)
                              for k, v in launch_counts().items()}
        return dict(sweeps=self.sweeps, nchains=int(self.model.nchains),
                    host_ms=dict(self.host_ms),
                    stream_ms=dict(self.stream_ms), counts=counts,
                    d2h_bytes=int(self.d2h_bytes))


class _Sweep:
    __slots__ = ("run", "rf")

    def __init__(self, run):
        self.run = run

    def __enter__(self):
        run = self.run
        if run.where == "head":
            run._end_head()
        run.where = "sweep"
        if run._edge is None:
            run._edge = run._stamp()
        run._first = run._edge
        self.rf = _label(run, "sweep")
        return self

    def __exit__(self, exc_type, exc, tb):
        run = self.run
        _close(self.rf)
        if exc_type is None:
            run._open.append(("sweep", run._first, run._edge))
            run.sweeps += 1
        return False


class _Phase:
    """A phase that starts at the last boundary and ends at a new one."""
    __slots__ = ("run", "name", "start", "rf")

    def __init__(self, run, name):
        self.run, self.name = run, name

    def __enter__(self):
        run = self.run
        if run._edge is None:
            run._edge = run._stamp()
        self.start = run._edge
        self.rf = _label(run, self.name)
        return self

    def __exit__(self, *exc):
        run = self.run
        run._edge = end = run._stamp()
        run._open.append((self.name, self.start, end))
        _close(self.rf)
        return False


class _Span:
    """A stream-clock span with its own start, inside a phase."""
    __slots__ = ("run", "name", "start", "rf")

    def __init__(self, run, name):
        self.run, self.name = run, name

    def __enter__(self):
        self.rf = _label(self.run, self.name)
        self.start = self.run._stamp()
        return self

    def __exit__(self, *exc):
        run = self.run
        run._open.append((self.name, self.start, run._stamp()))
        _close(self.rf)
        return False


class _Host:
    """A host-clock span; a flush's also resolves the stream's spans."""
    __slots__ = ("run", "name", "t0", "rf")

    def __init__(self, run, name):
        self.run, self.name = run, name

    def __enter__(self):
        run = self.run
        if self.name == "flush" and run.where == "sweep":
            run.where = "flush"
        self.rf = _label(run, self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        run = self.run
        run.host_ms[self.name] += 1e3 * (time.perf_counter() - self.t0)
        _close(self.rf)
        if self.name == "flush":
            run.resolve()
        return False
