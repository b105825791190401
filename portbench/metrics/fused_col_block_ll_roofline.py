"""The fused_col_block_ll kernel's share of its roofline (csrc/fused_ll.cu via
ops/fused_ll.py), %: the least time an H100 SXM could take for every
launch of the profiled sweeps, from each launch's own arguments by the
frozen work model (portbench/work/model.py), over the device time of those
launches by kernel name. None where the path launches no such kernel."""
from portbench.metrics._roofline import share

UNIT = "%"


def read(t):
    return share(t, "fused_col_block_ll")
