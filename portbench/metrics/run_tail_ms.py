"""ms a call from the moment the stream has run the window's last sweep to
the return of its ``run_gibbs`` (the program's ``tail`` span, host clock:
the draws' last flush to the host and the report with R-hat)."""
from portbench.metrics._program import host_ms

UNIT = "ms"


def read(t):
    return host_ms(t, "tail")
