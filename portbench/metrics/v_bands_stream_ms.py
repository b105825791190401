"""ms a sweep in the conjugate V update's band build (the program's
``v_bands`` span inside ``v_update``: the likelihood Gram einsum and the
prior's bands), on the device stream's clock with no synchronisation,
over the window's sweeps."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "v_bands")
