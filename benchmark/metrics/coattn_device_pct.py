"""The share of the traced steps' device time whose work was asked for
under the port's ``vln.vilbert.coattn`` spans, forward and backward
(``lib/program_spans.py``), in %; None where the traced steps hold no
such span (a program without them) or no device event."""

SPAN = "vln.vilbert.coattn"


def read(trace, work):
    by_span = work.get("device_by_span") or {}
    total = sum(by_span.values())
    if SPAN not in by_span or total <= 0:
        return None
    return 100.0 * by_span[SPAN] / total
