"""The card's time by the port's spans, read from a finished torch.profiler.

The port marks its layers with ``vln.`` spans (``utils/profiling.py``).
A device event (a kernel, copy or set) is matched to the API call that
launched it (``cuda*`` or ``cu*``) by correlation id, and belongs to the
span under way where its work was asked for:

* a launch made inside a backward node (autograd's ``evaluate_function:
  <Node>``, on whatever thread ran it) at the start of the forward op
  that made the node: the op on the forward's thread with the node's
  sequence number; so a layer's backward counts with its forward;
* any other launch at its runtime call's start.

The span at an instant is the innermost ``vln.`` span under way on any
thread, the latest started (``innermost``), as ``scripts/
torch_span_table.py`` puts the card's idle time.  Durations are the
device's own; the instants are the host's, so the device clock's drift
plays no part.
"""
from __future__ import annotations

import heapq
from bisect import bisect_right
from typing import Dict, List, Sequence, Tuple

PREFIX = "vln."
BACKWARD = "autograd::engine::evaluate_function: "
OUTSIDE = "(no vln span)"

Span = Tuple[str, float, float]


def innermost(spans: Sequence[Span]) -> List[Span]:
    """Disjoint (name, start, end) pieces, in order, each under way in the
    innermost of ``spans`` (the latest started; of two started together,
    the first to end) over the whole piece."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    by_start = sorted(range(len(spans)), key=lambda i: spans[i][1])
    active, out, k = [], [], 0
    for lo, hi in zip(edges, edges[1:]):
        while k < len(by_start) and spans[by_start[k]][1] <= lo:
            i = by_start[k]
            heapq.heappush(active, (-spans[i][1], spans[i][2], i))
            k += 1
        # a span that ended under a later-started one leaves the heap when it surfaces
        while active and active[0][1] <= lo:
            heapq.heappop(active)
        if not active:
            continue
        name = spans[active[0][2]][0]
        if out and out[-1][0] == name and out[-1][2] == lo:
            out[-1] = (name, out[-1][1], hi)
        else:
            out.append((name, lo, hi))
    return out


def device_by_span(prof) -> Dict[str, float]:
    """Seconds of device time by span name (``OUTSIDE`` where none is under
    way, or the launch is not found), over every device event of the
    finished profile ``prof``."""
    return attribute(*profile_lists(prof))


def profile_lists(prof) -> tuple:
    """The lists ``attribute`` reads, from a finished profile, in seconds."""
    from torch.autograd import DeviceType

    spans, launches, device, nodes, forward = [], {}, [], [], {}
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.id, b - a))
        elif e.name.startswith(PREFIX):
            spans.append((e.name, a, b))
        elif e.name.startswith("cu") and any(k in e.name for k in ("Launch", "Memcpy",
                                                                    "Memset")):
            launches[e.id] = a  # cuda* calls and cu* ones (cuBLAS's cuLaunchKernel)
        elif e.name.startswith(BACKWARD):
            nodes.append((a, b, (e.fwd_thread, e.sequence_nr)))
        elif e.sequence_nr >= 0 and e.name.startswith("aten::"):
            key = (e.thread, e.sequence_nr)
            forward[key] = min(forward.get(key, a), a)
    return spans, launches, device, nodes, forward


def attribute(spans: Sequence[Span], launches: Dict[int, float],
              device: Sequence[Tuple[int, float]], nodes: Sequence[Tuple[float, float, tuple]],
              forward: Dict[tuple, float]) -> Dict[str, float]:
    """``device_by_span`` on the profile's lists: spans (name, start, end),
    launch call starts by correlation id, device events (correlation id,
    seconds), backward nodes (start, end, (forward thread, sequence
    number)) and forward ops' starts by (thread, sequence number).  A
    thread runs one backward node at a time, so the latest started by an
    instant is the one under way there, if any."""
    pieces = innermost(spans)
    starts = [a for _, a, _ in pieces]
    nodes = sorted(n for n in nodes if n[2] in forward)
    node_starts = [a for a, _, _ in nodes]

    def asked_at(t: float) -> float:
        i = bisect_right(node_starts, t) - 1  # the latest node started by t, if it holds t
        return forward[nodes[i][2]] if i >= 0 and t <= nodes[i][1] else t

    def span_at(t: float) -> str:
        i = bisect_right(starts, t) - 1
        return pieces[i][0] if i >= 0 and t < pieces[i][2] else OUTSIDE

    out: Dict[str, float] = {}
    for cid, seconds in device:
        name = span_at(asked_at(launches[cid])) if cid in launches else OUTSIDE
        out[name] = out.get(name, 0.0) + seconds
    return out
