"""The share of the traced steps' text positions that hold padding, in %,
from the pretrainer's host-side counters (``engine/pretrain.py::
PretrainCounters``); None where the program keeps no such counters."""


def read(trace, work):
    text = work.get("text_positions")
    if not text:
        return None
    return 100.0 * work["pad_positions"] / text
