"""ms a sweep in the W and V updates' lifted black-box likelihood calls
(the program's ``blackbox_ll`` span inside the closures of
``_w_loglik_blackbox`` and ``_v_loglik_blackbox``), on the device
stream's clock with no synchronisation, over the window's sweeps. None on
a path with a cell function."""
from portbench.metrics._program import stream_ms_per_sweep

UNIT = "ms"


def read(t):
    return stream_ms_per_sweep(t, "blackbox_ll")
