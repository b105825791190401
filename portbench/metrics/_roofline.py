"""A fused kernel's roofline share from the profiled sweeps."""
from portbench.trace import KERNEL_NAMES


def share(t, kernel):
    """100 x (sum of the launches' bounds) / (their device time). Where
    the profiler kept another number of launches than the wrapper counted
    (a window can miss records), the bounds are scaled to the profiler's
    count. None without launches or device time."""
    if t.prof is None:
        return None
    bounds = t.prof["bounds"].get(kernel)
    pattern = KERNEL_NAMES[kernel]
    count = secs = 0
    for name, (n, s) in t.prof["kernels"].items():
        if pattern in name:
            count += n
            secs += s
    if not bounds or count == 0 or secs <= 0:
        return None
    bound_s = sum(bounds) / 1e6 * count / len(bounds)
    return 100.0 * bound_s / secs
