"""The model FLOPs the traced steps' inputs need (``lib/costs``), over the
traced window's time at the H100's bf16 dense peak, in %."""


def read(trace, work):
    if not work.get("flops") or trace.window_s <= 0:
        return None
    return 100.0 * work["flops"] / (trace.window_s * work["peak_flops"])
