"""The analysis of ``scripts/torch_span_table.py`` (the card's idle time by
the layer of the port's innermost ``vln.`` span, the host's blocking calls
inside the program) against hand-made spans and device intervals."""
import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_span_table.py"
_spec = importlib.util.spec_from_file_location("torch_span_table", _PATH)
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

WINDOW = (0.0, 10.0)


def test_a_gap_across_two_layers_is_split():
    # the card idles over [2, 6); the host is in the data layer until 4, then in the rollout
    got = S.idle_shares(WINDOW, [(0.0, 2.0), (6.0, 10.0)], [],
                        [("vln.iter", 0.0, 10.0), ("vln.data.next_batch", 1.0, 4.0),
                         ("vln.rollout.scan", 4.0, 9.0), ("vln.rollout.decode", 4.5, 5.5)])
    assert got == pytest.approx({"vln.data": 20.0, "vln.rollout": 20.0, "vln.update": 0.0,
                                 "device_idle": 40.0})


def test_innermost_is_the_latest_started():
    spans = [("vln.iter", 0.0, 10.0), ("vln.rollout.scan", 1.0, 8.0),
             ("vln.rollout.decode", 2.0, 3.0), ("vln.update.backward", 8.0, 9.5)]
    assert S.innermost(spans) == [
        ("vln.iter", 0.0, 1.0), ("vln.rollout.scan", 1.0, 2.0), ("vln.rollout.decode", 2.0, 3.0),
        ("vln.rollout.scan", 3.0, 8.0), ("vln.update.backward", 8.0, 9.5),
        ("vln.iter", 9.5, 10.0)]
    # a span of another thread that ends inside a later-started one
    assert S.innermost([("vln.a.x", 0.0, 3.0), ("vln.b.y", 1.0, 2.0)]) == [
        ("vln.a.x", 0.0, 1.0), ("vln.b.y", 1.0, 2.0), ("vln.a.x", 2.0, 3.0)]
    assert S.layer("vln.rollout.decode") == "vln.rollout" and S.layer("vln.iter") == "vln.iter"


def test_idle_time_in_the_benchmarks_copies_is_left_out():
    got = S.idle_shares(WINDOW, [(5.0, 10.0)], [(2.0, 3.0)], [("vln.rollout.decode", 1.0, 4.0)])
    assert got["vln.rollout"] == pytest.approx(20.0)
    assert got["device_idle"] == pytest.approx(50.0)


def test_the_layers_partition_part_of_the_idle_share():
    got = S.idle_shares(WINDOW, [(0.5, 1.0), (3.0, 3.5), (7.0, 7.2)], [(6.0, 6.5)],
                        [("vln.data.next_batch", 0.0, 1.5), ("vln.iter", 1.5, 9.0),
                         ("vln.rollout.encode", 2.0, 3.0), ("vln.rollout.packed", 3.0, 6.0),
                         ("vln.rollout.refill", 4.0, 4.5), ("vln.rollout.loss", 6.0, 7.0),
                         ("vln.update.backward", 7.0, 8.5), ("vln.data.record", 9.2, 9.8)])
    shares = [got[name] for name in S.LAYERS]
    assert shares == pytest.approx([16.0, 40.0, 13.0])
    assert got["device_idle"] == pytest.approx(88.0)
    assert sum(shares) <= got["device_idle"]
    # the rest: vln.iter alone over [1.5, 2) and [8.5, 9), no span over [9, 9.2) and
    # [9.8, 10), the copies over [6, 6.5)
    assert got["device_idle"] - sum(shares) == pytest.approx(5.0 + 5.0 + 2.0 + 2.0 + 5.0)


def test_syncs_outside_the_program_are_not_counted():
    program = [("vln.iter", 1.0, 5.0), ("vln.data.assemble", 4.0, 5.0)]
    syncs = [("cudaStreamSynchronize", 0.5, 0.6), ("cudaStreamSynchronize", 2.0, 2.1),
             ("cudaStreamSynchronize", 3.1, 3.2), ("cudaMemcpy", 4.5, 4.6),
             ("cudaDeviceSynchronize", 9.9, 10.0)]
    assert S.syncs_inside(program, syncs, [(3.0, 3.5)]) == 2


def test_a_trace_without_the_programs_spans_reads_none():
    assert S.idle_shares(WINDOW, [(0.0, 1.0)], [], []) is None
    assert S.syncs_inside([], [("cudaStreamSynchronize", 1.0, 2.0)], []) is None


def test_subtract_and_overlap():
    assert S.subtract([(0.0, 4.0), (5.0, 9.0)], [(1.0, 2.0), (1.5, 5.5), (8.0, 12.0)]) == \
        [(0.0, 1.0), (5.5, 8.0)]
    assert S.overlap([(0.0, 2.0), (3.0, 5.0)], [(1.0, 4.0)]) == pytest.approx(2.0)


def test_events_and_analyse_read_a_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from curriculum_learning_for_vln_torch.utils.profiling import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with span("iter"):
                with span("rollout.decode"):
                    torch.ones(4).sum()
                with span("update.backward"):
                    torch.ones(4).add(1)
    ev = S.events(prof)
    assert [n for n, *_ in ev["program"]] == ["vln.iter", "vln.rollout.decode",
                                             "vln.update.backward"]
    got = S.analyse(ev, steps=1)
    # no device events on the CPU: the whole window idle, split by the spans
    assert got["shares_pct"]["device_idle"] == pytest.approx(100.0)
    assert sum(got["shares_pct"][name] for name in S.LAYERS) <= 100.0
    assert got["per_step"]["vln.rollout.decode"]["count"] == 1
    assert got["k4"] == {"decode_spans": 1, "k4_launches": 0,
                         "decode_spans_holding_a_k4_launch": 0}
    assert got["syncs_per_step"] == 0


def _drifting(slope: float):
    """Launch calls every 50 ms over [0, 10) s on the host's clock, each
    kernel 5 us (a third queued 1 ms) after its call and 1 ms long, the
    device's times drifting by ``slope`` against the host's."""
    launches, device = {}, []
    for i in range(200):
        t = 0.05 * i
        launches[i] = ("cudaLaunchKernel", t, t + 2e-6)
        a = t + 5e-6 + (i % 3 == 0) * 1e-3
        device.append(("k", a * (1 + slope), (a + 1e-3) * (1 + slope), i))
    return {"window": WINDOW, "record": [], "syncs": [], "ops": [], "launches": launches,
            "device": device,
            "program": [("vln.iter", 0.0, 10.0)] + [("vln.rollout.decode", 0.05 * i, 0.05 * i + 0.01)
                                                   for i in range(200)]}


def test_a_drifting_device_clock_is_mapped_onto_the_hosts():
    ev = _drifting(-0.006)
    slope, offset = S.fit_drift([(ev["launches"][i][1], a - ev["launches"][i][1])
                                 for _k, a, _b, i in ev["device"]])
    assert slope == pytest.approx(-0.006, rel=1e-3)
    assert offset == pytest.approx(0.0, abs=1e-9)  # the least lead at the start is 5 us
    drifted, steady = S.analyse(ev, steps=1), S.analyse(_drifting(0.0), steps=1)
    assert drifted["clock"]["raw"]["kernel_before_its_launch"] > 150
    assert drifted["clock"]["after"]["kernel_before_its_launch"] == 0
    assert drifted["clock"]["drift_ppm"] == pytest.approx(-6000.0, rel=1e-3)
    for name in (*S.LAYERS, "device_idle"):
        assert drifted["shares_pct"][name] == pytest.approx(steady["shares_pct"][name], abs=0.01)
    assert steady["clock"]["raw"]["kernel_before_its_launch"] == 0
    assert S.fit_drift([]) == (0.0, 0.0)
