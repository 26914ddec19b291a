"""Top-level ATen ops the host dispatched (no ATen op above them), per
traced step (iteration or call), leaving out the benchmark's own copies
(``bench.record``, ``lib/launches.py``)."""
from bisect import bisect_right

from ..lib.launches import RECORD
from ..lib.trace import SPAN_PREFIX


def read(trace, work):
    if trace is None or not work.get("steps"):
        return None
    a, b = next((a, b) for n, a, b in trace.spans if n == SPAN_PREFIX + "window")
    ours = sorted((s, e) for n, s, e in trace.spans if n == SPAN_PREFIX + RECORD)
    starts = [s for s, _ in ours]

    def recorded(t: float) -> bool:
        i = bisect_right(starts, t) - 1
        return i >= 0 and t < ours[i][1]

    return sum(1 for _, s, _e in trace.host_ops if a <= s < b and not recorded(s)) / work["steps"]
