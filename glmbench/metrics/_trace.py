"""Reduce a ``torch.profiler`` trace to what the per-layer metrics read.

The arithmetic of ``tools/profile_irls_step.py`` (device time by kernel,
launches) with the device's busy time taken as the union of its
operations' intervals, the idle gaps named by what the host was doing, and
the device time of each of the benchmark's spans.  The spans are
``record_function`` ranges named ``glmbench/<name>``; their device-side
copies are left out of the device's operations.
"""

import bisect
import sys

SPAN_PREFIX = "glmbench/"


def union_us(intervals) -> tuple:
    """(total covered length, the merged intervals), of (start, end) pairs."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), merged


def _innermost(starts, events, t, max_back: int = 256):
    """The latest-starting event of ``events`` (sorted by start) that
    covers ``t``: the innermost of nested ranges on one thread."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - max_back), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def idle_gaps(merged, t0: float, t1: float) -> list:
    """(start, end) of each stretch of [t0, t1] with no device operation."""
    gaps, cursor = [], t0
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(s, e) for s, e in gaps if e > s]


def summarize(device_events, host_events, t0: float, t1: float) -> dict:
    """The trace's numbers, times in microseconds on the profiler's clock.

    ``device_events``: (start, end, name, launched) of each operation the
    device ran, ``launched`` the host time of the runtime call that queued
    it; ``host_events``: (start, end, name) of the host's ranges (the spans
    and the framework's ops and runtime calls of the thread that drives the
    card); [t0, t1]: the traced window.  A span's device time is that of
    the operations launched while it was the innermost span open.
    """
    busy, merged = union_us((s, e) for s, e, _, _ in device_events)
    by_name = {}
    for s, e, name, _ in device_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    spans = sorted((s, e, n[len(SPAN_PREFIX):]) for s, e, n in host_events
                   if n.startswith(SPAN_PREFIX))
    ops = sorted((s, e, n) for s, e, n in host_events if not n.startswith(SPAN_PREFIX))
    span_starts, op_starts = [s for s, _, _ in spans], [s for s, _, _ in ops]
    span_device = {}
    for _, _, name in spans:
        calls, us = span_device.get(name, (0, 0.0))
        span_device[name] = (calls + 1, us)
    for s, e, _, launched in device_events:
        name = _innermost(span_starts, spans, launched)
        if name is not None:
            calls, us = span_device[name]
            span_device[name] = (calls, us + (e - s))
    idle_by = {}
    for s, e in idle_gaps(merged, t0, t1):
        mid = 0.5 * (s + e)
        span = _innermost(span_starts, spans, mid) or "outside spans"
        op = _innermost(op_starts, ops, mid) or "python"
        key = f"{span}: {op}"
        idle_by[key] = idle_by.get(key, 0.0) + (e - s)
    return {
        "busy_us": busy,
        "window_us": t1 - t0,
        "device_ops": len(device_events),
        "device_us": sum(e - s for s, e, _, _ in device_events),
        "by_name": by_name,
        "idle_by_host": idle_by,
        "span_device_us": span_device,
    }


def from_profiler(prof) -> dict:
    """``summarize`` over a finished ``torch.profiler.profile``.  A device
    operation and the runtime call that queued it share a correlation id
    (the events' ``id``)."""
    from torch.autograd import DeviceType

    events = prof.events()
    threads = {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            threads[e.thread] = threads.get(e.thread, 0) + 1
    # the thread that drives the card issues most of the host events
    main = max(threads, key=threads.get) if threads else None
    device, host, launches = [], [], {}
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):
                device.append((start, end, e.name, e.id))
        elif e.device_type == DeviceType.CPU and e.thread == main:
            host.append((start, end, e.name))
            if e.name.startswith("cu"):
                launches[e.id] = start
    if not device:
        raise RuntimeError("the trace holds no device operation: the profiler saw no kernel")
    matched = sum(1 for *_, cid in device if cid in launches)
    if matched < len(device):
        print(f"glmbench: {len(device) - matched} of {len(device)} device operations have no "
              "launch in the trace; they count where they ran", file=sys.stderr)
    device = [(s, e, n, launches.get(cid, s)) for s, e, n, cid in device]
    t0 = min(min(s for s, _, _ in host), min(s for s, _, _, _ in device))
    t1 = max(max(e for _, e, _ in host), max(e for _, e, _, _ in device))
    return summarize(device, host, t0, t1)


def idle_share(ctx):
    """The share of the traced window, in %, in which no operation ran on
    the device; None without a trace."""
    trace = ctx.get("trace")
    if trace is None or trace["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_us"] / trace["window_us"])


def breakdown(summary: dict, top: int = 10) -> dict:
    """The traced window's ``breakdown``: the device operations that took
    most time, and the idle time summed by what the host was doing, in
    seconds."""
    def ranked(d):
        return [[name[:160], us * 1e-6] for name, us in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(summary["by_name"]),
            "idle_gaps": ranked(summary["idle_by_host"])}
