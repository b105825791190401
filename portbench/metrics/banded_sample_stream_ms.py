"""ms a sweep in the conjugate V update's block-banded draw (the program's
``banded_sample`` span inside ``v_update``: equilibration, the retiled
factor scan and its solves), on the device stream's clock with no
synchronisation, over the window's sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "banded_sample")
