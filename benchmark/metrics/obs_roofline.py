"""K4-K7 (``csrc/pano_fused.cu``, ``csrc/cand_score.cu``): the traced
launches' bounds over their device time, by kernel name, in %."""
from ._kernels import roofline_pct


def read(trace, work):
    return roofline_pct(trace, work, "obs")
