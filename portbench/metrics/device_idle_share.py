"""The share of the profiled window with no kernel or copy on the card, %
(torch.profiler's device events, their union over the window)."""
UNIT = "%"


def read(t):
    if t.prof is None or t.prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t.prof["busy_s"] / t.prof["window_s"])
