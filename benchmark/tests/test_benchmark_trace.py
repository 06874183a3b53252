"""The trace readers on synthetic profiler events: the device's busy
union and idle share, copies a scan, the kernel kinds' roofline, the idle
gaps by host activity, the top device operations."""

from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness
from benchmark.devtrace import Event, Trace

MS = 1_000_000  # ns


def trace(kernels=(), copies=(), sets=(), host=(), window=(0, 100 * MS)):
    return Trace([Event(*k) for k in kernels], [Event(*c) for c in copies],
                 [Event(*s) for s in sets], [Event(*h) for h in host],
                 window)


def test_union_of_overlapping_intervals():
    t = trace(kernels=[("a", 0, 10 * MS), ("b", 5 * MS, 20 * MS),
                       ("c", 30 * MS, 40 * MS)],
              copies=[("HtoD", 35 * MS, 50 * MS)])
    assert devtrace.busy_seconds(t) == pytest.approx(0.040)
    assert devtrace.busy_intervals(t) == [(0, 20 * MS), (30 * MS, 50 * MS)]


def test_idle_share_and_copies_per_scan():
    t = trace(kernels=[("a", 0, 25 * MS)],
              copies=[("HtoD", 30 * MS, 40 * MS), ("DtoH", 50 * MS, 55 * MS),
                      ("DtoD", 60 * MS, 70 * MS)])
    ctx = SimpleNamespace(trace=t, window_s=0.1, scans=3)
    assert harness.idle_share(ctx) == pytest.approx(50.0)
    copy = harness.reader("copy_ms_per_scan.segment")
    assert copy.read(ctx) == pytest.approx(15.0 / 3)


def test_idle_gaps_by_innermost_host_event():
    t = trace(kernels=[("k", 10 * MS, 20 * MS), ("k", 60 * MS, 100 * MS)],
              host=[("bench.window", 0, 100 * MS),
                    ("bench.segment", 0, 100 * MS),
                    ("aten::copy_", 25 * MS, 55 * MS),
                    ("cudaMemcpyAsync", 26 * MS, 54 * MS)])
    gaps = dict(devtrace.idle_gaps(t))
    # [0, 10) falls inside bench.segment only; [20, 60) has its middle in
    # the copy's cudaMemcpyAsync.
    assert gaps == {"cudaMemcpyAsync": pytest.approx(0.040),
                    "bench.segment": pytest.approx(0.010)}


def test_device_ops_sum_by_name():
    t = trace(kernels=[("k1", 0, 3 * MS), ("k2", 5 * MS, 6 * MS),
                       ("k1", 10 * MS, 12 * MS)],
              copies=[("HtoD", 20 * MS, 24 * MS)], sets=[("s", 30, 40)])
    ops = devtrace.device_ops(t)
    assert ops[0] == ["k1", pytest.approx(0.005)]
    assert ops[1] == ["Memcpy HtoD", pytest.approx(0.004)]


def test_kind_of_takes_the_longest_fragment():
    kinds = harness.kernel_kinds()
    assert harness.kind_of("void in_prelu_bwd_saved_dx_kernel<float, 4>",
                           kinds) == "k2b"
    assert harness.kind_of("void in_prelu_bwd_dx_kernel<float, 4>",
                           kinds) == "k1b"
    assert harness.kind_of("void in_prelu_fwd_cluster_kernel<float>",
                           kinds) == "k1f"
    assert harness.kind_of("shallow_dwt_kernel<2>", kinds) == "shallow_dwt"
    assert harness.kind_of("shallow_dw_kernel<4>", kinds) == "shallow_dw"
    assert harness.kind_of("sm80_xmma_dgrad_implicit_gemm", kinds) is None


def test_roofline_sums_least_over_device_time():
    kinds = harness.kernel_kinds()
    t = trace(kernels=[("in_prelu_fwd_cluster_kernel", 0, 4 * MS),
                       ("conv3x3_wgmma_kernel", 4 * MS, 10 * MS),
                       ("sm80_xmma_fprop", 10 * MS, 40 * MS)])
    ctx = SimpleNamespace(trace=t, kinds=kinds,
                          least_s={"k1f": 0.002, "k2f": 0.003})
    # (2 + 3) ms of least time over the port's 10 ms; the library's 30 ms
    # are not the port's.
    assert harness.kernels_roofline(ctx) == pytest.approx(50.0)
    ctx.least_s["k2f"] = None  # a kind whose work is not known
    assert harness.kernels_roofline(ctx) is None


def test_least_seconds_needs_the_counters_agreement():
    kinds = harness.kernel_kinds()
    site = {"op": "conv_unit", "dims": 2, "transposed": False, "k": 3,
            "stride": 1, "act": True, "x": (2, 64, 32, 32),
            "y": (2, 64, 32, 32), "itemsize": 4, "grad": False}
    got = harness.least_seconds([site], kinds, {"k2f": 1})
    products = 2 * 9 * 64 * 64 * 2 * 32 * 32
    moved = 4 * (2 * 32 * 32 * 64 * 2 + 9 * 64 * 64)
    assert got["k2f"] == pytest.approx(max(products / 495e12,
                                           8 * 2 * 32 * 32 * 64 / 67e12,
                                           moved / 3.35e12))
    assert got["k1f"] == 0
    assert harness.least_seconds([site], kinds, {"k2f": 2})["k2f"] is None


def test_library_conv_ms_leaves_the_ports_kernels_out():
    kinds = harness.kernel_kinds()
    t = trace(kernels=[("conv3x3_wgmma_kernel", 0, 5 * MS),
                       ("sm80_xmma_wgrad_implicit_gemm", 5 * MS, 9 * MS),
                       ("void cudnn::detail::dgrad_engine<float>", 9 * MS,
                        11 * MS),
                       ("at::native::elementwise_kernel", 11 * MS, 20 * MS)])
    ctx = SimpleNamespace(trace=t, kinds=kinds, steps=2)
    assert harness.reader("library_conv_ms.train").read(ctx) == \
        pytest.approx(3.0)


def test_readers_find_nothing_without_a_trace():
    ctx = SimpleNamespace(trace=None, window_s=0.0, steps=0, scans=0,
                          model_slices=0, least_s={}, kinds={})
    for name in ("kernels_roofline.train", "library_conv_ms.train",
                 "copy_ms_per_scan.segment", "device_idle_share.train",
                 "mfu.train", "mfu.segment"):
        assert harness.reader(name).read(ctx) is None
