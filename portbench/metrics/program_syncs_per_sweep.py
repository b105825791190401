"""Host syncs a sweep that the program counts at its sync sites (the
``sync:*`` counters of the run record inside the window's sweeps: the
jitter ladder's check of ``cholesky_psd``, the shrink and ESS loops' stop
test, the banded Cholesky's backstop, the black-box V rounds' block starts
copied to the card), over the window's sweeps."""
from portbench.metrics._program import window_record

UNIT = "syncs"


def read(t):
    rec = window_record(t)
    if rec is None:
        return None
    inside = rec["counts"].get("sweep", {})
    return sum(n for site, n in inside.items()
               if site.startswith("sync:")) / rec["sweeps"]
