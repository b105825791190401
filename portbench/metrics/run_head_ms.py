"""ms a call from the window's ``run_gibbs`` entry to its first sweep's
first launch (the program's ``head`` span, host clock: the feasibility
check, ``prepare_data``, ``_make_sweep``)."""
from portbench.metrics._program import host_ms

UNIT = "ms"


def read(t):
    return host_ms(t, "head")
