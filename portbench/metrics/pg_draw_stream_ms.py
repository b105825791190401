"""ms a sweep in the Polya-Gamma draw of omega (the program's ``pg_draw``
phase: NegBinom's pseudo-counts, the gamma noise, the fixed-round
Marsaglia-Tsang gammas and the truncated sum), on the device stream's
clock with no synchronisation, over the window's sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "pg_draw")
