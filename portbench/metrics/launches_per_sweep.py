"""Kernel launches a sweep in the profiled window (device kernel events,
copies and memsets left out)."""
UNIT = "launches"


def read(t):
    if t.prof is None:
        return None
    return t.prof["kernel_launches"] / t.prof["sweeps"]
