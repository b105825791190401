"""ms a sweep in NegBinom's Metropolis moves on its dispersion R (the
program's ``r_moves`` phase: 30 moves, each four full-tensor lgammas and a
sum over the cells R is shared by), on the device stream's clock with no
synchronisation, over the window's sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "r_moves")
