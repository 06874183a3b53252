"""The readers of the program's own spans (`ctseg.`,
ctseg_tpu_torch/utils/profiling.py) on synthetic traces and on a traced
CPU run of the segmentation cell: the device's idle time a scan under the
scan's host work, the host's wait for the device a scan, None on a trace of
a program without the spans; and the idle gaps' breakdown naming the
program's spans inside the benchmark's."""

from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness
from benchmark.devtrace import Event, Trace
from benchmark.run import run_workload
from benchmark.tests.conftest import TINY_SEED, tiny_cell

MS = 1_000_000  # ns
NEW = ("scan_host_idle_ms.segment", "scan_sync_wait_ms.segment")


def scan_trace(program_spans=True):
    """Two scans of one batch each: the host crops, casts, copies in,
    launches, stores (waiting for the labels first) and pastes; the device runs the copy in, the
    forward, the copy back, and a kernel of the next step after the crop's
    box and after the store."""
    host = [("bench.window", 0, 100 * MS)]
    kernels, copies = [], []
    for at in (0, 50 * MS):
        host.append(("bench.segment", at, at + 50 * MS))
        if program_spans:
            host += [("ctseg.scan", at, at + 50 * MS),
                     ("ctseg.scan.crop", at, at + 4 * MS),
                     ("ctseg.scan.crop", at + 4 * MS, at + 5 * MS),
                     ("ctseg.scan.cast", at + 5 * MS, at + 11 * MS),
                     ("ctseg.scan.h2d", at + 11 * MS, at + 13 * MS),
                     ("ctseg.scan.forward", at + 13 * MS, at + 16 * MS),
                     ("ctseg.scan.store", at + 16 * MS, at + 44 * MS),
                     ("ctseg.sync", at + 16 * MS, at + 40 * MS),
                     ("ctseg.scan.paste", at + 44 * MS, at + 50 * MS)]
        host += [("aten::copy_", at + 11 * MS, at + 13 * MS),
                 ("aten::copy_", at + 16 * MS, at + 40 * MS)]
        copies += [("HtoD", at + 11 * MS, at + 13 * MS),
                   ("DtoH", at + 38 * MS, at + 40 * MS)]
        kernels += [("k", at + 13 * MS, at + 38 * MS),
                    ("a", at + 4 * MS, at + 5 * MS),
                    ("b", at + 44 * MS, at + 45 * MS)]
    return Trace([Event(*k) for k in kernels], [Event(*c) for c in copies],
                 [], [Event(*h) for h in host], (0, 100 * MS))


def ctx_of(trace, scans=2):
    return SimpleNamespace(trace=trace, window_s=0.1, scans=scans, steps=0)


def test_host_idle_a_scan_under_the_scans_host_work():
    got = harness.reader("scan_host_idle_ms.segment").read(ctx_of(scan_trace()))
    # the idle device, each gap by its middle: [0, 4) under the crop, [5,
    # 11) the cast, [40, 44) the store, [45, 54) the paste (the next scan's
    # crop with it), and so on
    assert got == pytest.approx((4 + 6 + 4 + 9 + 6 + 4 + 5) / 2)


def test_sync_wait_a_scan():
    got = harness.reader("scan_sync_wait_ms.segment").read(ctx_of(scan_trace()))
    assert got == pytest.approx(24.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_programs_spans(name):
    reader = harness.reader(name)
    assert reader.read(ctx_of(scan_trace(program_spans=False))) is None
    assert reader.read(ctx_of(None, scans=0)) is None
    assert reader.read(ctx_of(scan_trace(), scans=0)) is None


def test_the_breakdown_names_the_programs_spans():
    """The idle gaps the benchmark put under `bench.segment` fall under the
    program's spans, or the torch calls inside them."""
    before = dict(devtrace.idle_gaps(scan_trace(program_spans=False)))
    after = dict(devtrace.idle_gaps(scan_trace()))
    assert before == {"bench.segment": pytest.approx(2 * 0.019)}
    assert after == {"ctseg.scan.crop": pytest.approx(0.004),
                     "ctseg.scan.cast": pytest.approx(0.012),
                     "ctseg.scan.store": pytest.approx(0.008),
                     "ctseg.scan.paste": pytest.approx(0.014)}


def test_a_traced_cpu_run_reads_the_programs_spans():
    """The real collect over torch.profiler keeps the program's spans as
    host events: the cell's traced run reports both new metrics (on the
    CPU the whole window is one idle gap, put down to one host event)."""
    result = run_workload("model_l.segment", TINY_SEED, 0.5, True, "cpu",
                          tiny_cell("model_l.segment"))
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["scan_host_idle_ms.segment"]["value"] >= 0
    assert metrics["scan_sync_wait_ms.segment"]["value"] > 0
