"""The trace reader: the union of device intervals, the idle gaps and
their names, the kernels of a CUDA source, against hand-made inputs."""
import pytest

from benchmark.lib import trace as T


def test_union_and_gaps():
    spans = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (6.5, 6.8)]
    assert T.union(spans) == pytest.approx(4.0)
    assert T.gaps(spans, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert T.gaps(spans, 2.0, 6.5) == [(4.0, 6.0)]
    assert T.union([]) == 0.0


def test_breakdown_names_gaps_by_host():
    tr = T.Trace(window=(0.0, 10.0),
                 device=[("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("k1", 6.0, 7.0)],
                 spans=[("bench.window", 0.0, 10.0), ("bench.step", 3.5, 8.0)],
                 host_ops=[("aten::item", 4.5, 5.5)])
    assert tr.busy_s == pytest.approx(4.0)
    assert tr.window_s == 10.0
    assert tr.device_by_name() == pytest.approx({"k1": 3.0, "k2": 2.0})
    b = tr.breakdown()
    assert b["device_ops"] == [["k1", pytest.approx(3.0)], ["k2", pytest.approx(2.0)]]
    assert b["idle_gaps"][0] == ["window / python", pytest.approx(3.0)]
    assert ["step / aten::item", pytest.approx(2.0)] in b["idle_gaps"]


def test_kernel_label_and_source_kernels(tmp_path):
    assert T.kernel_label("void (anonymous namespace)::bwd_kernel<float, 4>(int, float*)") == \
        "bwd_kernel"
    src = tmp_path / "k.cu"
    src.write_text("template <int N>\n__global__ void __launch_bounds__(N, 2)\nalpha(int x) {}\n"
                   "__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(256)\n"
                   "beta_kernel(float* y) {}\n__device__ void gamma(int) {}\n")
    assert T.source_kernels(src) == {"alpha", "beta_kernel"}


def test_frozen_kernel_names_are_the_ports():
    from pathlib import Path

    import curriculum_learning_for_vln_torch as pkg
    from benchmark.metrics import _kernels as K

    csrc = Path(pkg.__file__).resolve().parent / "csrc"
    ported = set().union(*(T.source_kernels(p) for p in csrc.glob("*.cu")))
    frozen = K.frozen()
    assert set(frozen["csrc"]) == ported
    named = {n for fam in frozen["families"].values() for n in fam}
    named |= {n for groups in frozen["launches"].values() for g in groups for n in g}
    assert named <= K.csrc_names()
    for launch, groups in frozen["launches"].items():
        family = launch.split(".")[0]
        assert all(set(g) <= set(frozen["families"][family]) for g in groups), launch


def test_roofline_read_needs_the_named_kernels():
    from benchmark.metrics import _kernels as K

    work = {"bounds_s": {"obs": {"pano": 1.0, "cand_fwd": 0.5, "cand_bwd": 0.0}}}
    tr = T.Trace(window=(0.0, 10.0), device=[("pano_kernel", 0.0, 2.0),
                                             ("cand_score_kernel", 2.0, 3.0),
                                             ("elementwise_kernel", 3.0, 9.0)],
                 spans=[("bench.window", 0.0, 10.0)], host_ops=[])
    assert K.roofline_pct(tr, work, "obs") == pytest.approx(50.0)
    # a launch with a bound whose kernel is not in the trace stops the read
    gone = tr._replace(device=[d for d in tr.device if d[0] != "cand_score_kernel"])
    with pytest.raises(RuntimeError, match="cand_fwd"):
        K.roofline_pct(gone, work, "obs")
    # no device events, or no bound: nothing to read
    assert K.roofline_pct(tr._replace(device=[]), work, "obs") is None
    assert K.roofline_pct(tr, {"bounds_s": {}}, "obs") is None


def test_host_ops_leave_out_the_recorders_copies():
    from benchmark.metrics import host_ops

    tr = T.Trace(window=(0.0, 10.0), device=[],
                 spans=[("bench.window", 0.0, 10.0), ("bench.record", 2.0, 3.0),
                        ("bench.record", 5.0, 5.5)],
                 host_ops=[("aten::mm", 1.0, 1.5), ("aten::clone", 2.1, 2.2),
                           ("aten::clone", 5.1, 5.2), ("aten::add", 6.0, 6.1),
                           ("aten::add", 11.0, 11.1)])
    assert host_ops.read(tr, {"steps": 2}) == 1.0
