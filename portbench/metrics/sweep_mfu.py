"""The whole sweep's share of the H100's FP32 peak, %: the grid work a
sweep needs (the W and V updates' GASS candidates over every cell, by the
frozen work model; the scale moves' slice steps left out) over the
measured window's sweep time (stretch 1: no span, no profiler) x 67
TFLOP/s, the published FP32 rate of an H100 SXM at 700 W."""
from portbench.work.model import H100

UNIT = "%"


def read(t):
    if not t.nsweeps or t.window_s <= 0:
        return None
    return 100.0 * t.flops_per_sweep / (t.window_s / t.nsweeps) \
        / H100["fp32_per_s"]
