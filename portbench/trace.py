"""Reduction of a ``torch.profiler`` trace of the measured window.

Device intervals are the kernels, memsets and copies the profiler
recorded.  Each is tied to the host: through its correlation id to the
runtime call that launched it (else through its linked id to the host
operation), and through that call's start to the
innermost benchmark span (``record_function`` range) open at that moment.
Idle time is the window less the union of the device intervals; each idle
gap is named by what the host was doing at its midpoint: the innermost
span and the innermost host operation open there.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

WINDOW = "window"
TOP = 10


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    span_calls: dict          # span name -> calls in the window
    span_device_s: dict       # span name -> device seconds launched in it
    device_ops: list          # [[name, seconds]], the longest first
    idle_gaps: list           # [[host activity, seconds]], the longest first
    kernels: int              # device operations in the window


def _innermost(starts, items, t, look_back=64):
    """The latest-starting interval of ``items`` (sorted by start) that
    contains ``t``, the innermost of nested intervals, among the
    ``look_back`` that start last before ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        s, e, name = items[j]
        if e >= t:
            return name
    return None


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, spans):
    """``events``: ``(name, on_device, start_ns, end_ns, correlation,
    linked_correlation, thread)`` tuples; ``spans``: the benchmark's span
    names.  The window is the span named ``WINDOW``."""
    win = [e for e in events if not e[1] and e[0] == WINDOW]
    if not win:
        return None
    w0, w1, host_thread = win[0][2], win[0][3], win[0][6]
    span_items, host_items, runtime_at, op_at = [], [], {}, {}
    device = []
    for name, on_device, s, e, corr, linked, thread in events:
        if on_device:
            # the tracer also puts each span and its synchronization waits
            # on the device's timeline: neither is work
            if (s >= w0 and e <= w1 and "Sync" not in name
                    and name not in spans and name != WINDOW):
                device.append((s, e, name, corr, linked))
            continue
        (runtime_at if name.startswith("cu") else op_at).setdefault(corr, s)
        if thread != host_thread or s < w0 or s > w1:
            continue
        if name in spans:
            span_items.append((s, e, name))
        elif name != WINDOW:
            host_items.append((s, e, name))
    span_items.sort()
    host_items.sort()
    span_starts = [s for s, _, _ in span_items]
    host_starts = [s for s, _, _ in host_items]

    span_calls = defaultdict(int)
    for _, _, name in span_items:
        span_calls[name] += 1
    span_dev = defaultdict(float)
    by_name = defaultdict(float)
    for s, e, name, corr, linked in device:
        by_name[name] += (e - s) * 1e-9
        t = runtime_at.get(corr, op_at.get(linked))
        if t is None:
            continue
        span = _innermost(span_starts, span_items, t)
        if span is not None:
            span_dev[span] += (e - s) * 1e-9

    busy = _union((s, e) for s, e, _, _, _ in device)
    busy_ns = sum(e - s for s, e in busy)
    idle = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        what = "/".join(x for x in (
            _innermost(span_starts, span_items, mid),
            _innermost(host_starts, host_items, mid)) if x) or "host"
        idle[what] += (b - a) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return Summary((w1 - w0) * 1e-9, busy_ns * 1e-9, dict(span_calls),
                   dict(span_dev), top(by_name), top(idle), len(device))


def kineto_events(prof):
    """The flat event list of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        out.append((ev.name(), ev.device_type() != DeviceType.CPU,
                    ev.start_ns(), ev.end_ns(), ev.correlation_id(),
                    ev.linked_correlation_id(), ev.start_thread_id()))
    return out
