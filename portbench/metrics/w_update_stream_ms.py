"""ms a sweep in the W update (the program's ``w_update`` phase: GASS over
the rows with its non-finite guard), on the device stream's clock with no
synchronisation, over the window's sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "w_update")
