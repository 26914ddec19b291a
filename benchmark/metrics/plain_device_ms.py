"""Device time of every event that no ``csrc/`` kernel made (library
kernels, copies, sets), per traced step (iteration or call), in ms."""
from ._kernels import csrc_names


def read(trace, work):
    if trace is None or not work.get("steps"):
        return None
    ours = csrc_names()
    spent = sum(s for n, s in trace.device_by_name().items() if n not in ours)
    return 1e3 * spent / work["steps"]
