"""ms a sweep in the scale moves (the program's ``scale_moves`` phase:
``_interweave_scales``), on the device stream's clock with no
synchronisation, over the window's sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "scale_moves")
