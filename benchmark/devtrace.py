"""torch.profiler's trace of a window, reduced to what the per-layer
readers need: the device's kernels, copies and sets with their times, the
host's operations, and the sums built from them.

Device intervals are read from the profiler's CUPTI records (kernels,
memcpy, memset); the host's from its CPU operator events and the
benchmark's own spans (`torch.profiler.record_function` around each call
into the program).
"""

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    kernels: List[Event]    # device kernels
    copies: List[Event]     # device memcpy, name "HtoD", "DtoH" or other
    sets: List[Event]       # device memset
    host: List[Event]       # host operations and spans, main thread
    window_ns: Tuple[int, int]


def _copy_kind(name: str) -> str:
    for kind in ("HtoD", "DtoH", "DtoD", "HtoH"):
        if kind in name:
            return kind
    return "other"


def collect(prof, window_span: str, span_prefix: str) -> Trace:
    """The profiler's events; the window is that of the host span named
    `window_span`. Spans (names starting with `span_prefix`) are host
    events only."""
    from torch.autograd import DeviceType

    kernels, copies, sets, host = [], [], [], []
    raw = prof.profiler.kineto_results.events()
    # The host thread is the one that opened the window's span; autograd's
    # backward runs on a thread of its own.
    main = next((e.start_thread_id() for e in raw
                 if e.device_type() == DeviceType.CPU
                 and e.name() == window_span), None)
    for e in raw:
        start = e.start_ns()
        ev = Event(e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or ev.name.startswith(span_prefix):
                continue  # a span's shadow on the device, no work
            low = ev.name.lower()
            if low.startswith("memcpy"):
                copies.append(ev._replace(name=_copy_kind(ev.name)))
            elif low.startswith("memset"):
                sets.append(ev)
            else:
                kernels.append(ev)
        elif not e.is_async() and e.start_thread_id() == main:
            host.append(ev)
    window = next(((e.start_ns, e.end_ns) for e in host
                   if e.name == window_span), (0, 0))
    return Trace(kernels, copies, sets, host, window)


def busy_intervals(trace: Trace) -> List[Tuple[int, int]]:
    """The merged intervals in which the device ran anything."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((e.start_ns, e.end_ns)
                       for e in trace.kernels + trace.copies + trace.sets):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(trace: Trace) -> float:
    """The length of the union of the device's intervals."""
    return sum(e - s for s, e in busy_intervals(trace)) / 1e9


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    """The device operations that took most time: [[name, seconds], ...]."""
    sums: Dict[str, int] = defaultdict(int)
    for e in trace.kernels:
        sums[e.name[:160]] += e.end_ns - e.start_ns
    for e in trace.copies:
        sums["Memcpy " + e.name] += e.end_ns - e.start_ns
    for e in trace.sets:
        sums["Memset"] += e.end_ns - e.start_ns
    rows = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in rows]


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle (the innermost host event there):
    [[name, seconds], ...], the largest first."""
    lo, hi = trace.window_ns
    gaps, at = [], lo
    for s, e in busy_intervals(trace):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    # Host events on one thread nest, so the ones open at a time form a
    # stack whose top is the innermost.
    host = sorted(trace.host, key=lambda e: (e.start_ns, -e.end_ns))
    sums: Dict[str, int] = defaultdict(int)
    stack: List[Event] = []
    i = 0
    for s, e in sorted(g for g in gaps if g[1] > g[0]):
        mid = (s + e) // 2
        while i < len(host) and host[i].start_ns <= mid:
            while stack and stack[-1].end_ns < host[i].start_ns:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_ns < mid:
            stack.pop()
        sums[stack[-1].name[:160] if stack else "(no host event)"] += e - s
    rows = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in rows]
