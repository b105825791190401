"""ms a sweep in the V update's rounds (the program's ``v_update`` phase),
on the device stream's clock with no synchronisation, over the window's
sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "v_update")
