"""K1-K3 (``csrc/lstm_scan.cu``): the traced launches' bounds over their
device time, by kernel name, in %."""
from ._kernels import roofline_pct


def read(trace, work):
    return roofline_pct(trace, work, "lstm_scan")
