"""The traced run: ``torch.profiler`` around a bounded number of steps, and
the reduction of its events to what the per-layer metrics read.

Nothing is written to disk: the events are read from the profiler in
memory. ``window`` is the span ``portbench.window`` that wraps the traced
steps and ends in a synchronize; the device is busy where any device
activity (kernel, copy, set) ran inside it.

The host's time to issue a step is its ``portbench.step`` span less the
time its CUDA runtime calls (names ``cu*``: launches, copies, sets) spent
over what a call of the same name takes when it does not wait, and less
every synchronize: a launch that waits for room in a full launch queue,
or a synchronize, waits on the card, and that wait is the card's time,
not the host's.
"""

from __future__ import annotations

import bisect
import re
import statistics
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
STEP_SPAN = "portbench.step"
# device-side records that are waits or the spans' own annotations, and
# the profiler's own host work, none of them the program's
_DEVICE_WAITS = ("Sync", "Wait")
_SPANS = (WINDOW_SPAN, STEP_SPAN)
_PROFILER_HOST = ("Activity Buffer Request",)
TOP = 10
# consecutive runtime calls of one name whose median is a call's cost
RUN = 64


def profile(step, n, device):
    """Run ``step()`` ``n`` times under ``torch.profiler`` (CPU and, on a
    card, CUDA activity); returns the events as (name, on_device, start_s,
    end_s) tuples."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(n):
                with record_function(STEP_SPAN):
                    step()
            if cuda:
                torch.cuda.synchronize(device)
    return events_of(prof)


def events_of(prof):
    """(name, on_device, start_s, end_s) of every profiler event."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() != DeviceType.CPU,
             e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in prof.profiler.kineto_results.events()]


def short_name(name):
    """A kernel's name without its return type, arguments and PyTorch's
    namespaces, in the characters of a benchmark name, at most 64."""
    for noise in ("(anonymous namespace)::", "at::native::", "at::", "c10::"):
        name = name.replace(noise, "")
    name = re.sub(r"^void\s+", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return re.sub(r"[^A-Za-z0-9_.]+", "_", name[:cut]).strip("_")[:64]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _unblocked(durations):
    """What a runtime call of one name takes when it does not wait: the
    least median of RUN consecutive calls (the median of them all where
    there are fewer). Once the launch queue is full most launches wait,
    so the median of them all would be a wait."""
    if len(durations) < RUN:
        return statistics.median(durations)
    return min(statistics.median(durations[i:i + RUN])
               for i in range(0, len(durations) - RUN + 1, RUN))


def host_issue_ms(events, w0, w1):
    """Per ``portbench.step`` span in the window, the host's milliseconds
    to issue the step: the span less the waits of its CUDA runtime calls,
    each call's time over what a call of its name takes unblocked
    (``_unblocked``), and the whole of every synchronize."""
    calls = sorted((s, e, n) for n, dev, s, e in events
                   if not dev and n.startswith("cu") and w0 <= s < w1)
    by_name = defaultdict(list)
    for s, e, n in calls:
        by_name[n].append(e - s)
    base = {n: (0.0 if "Synchronize" in n else _unblocked(d))
            for n, d in by_name.items()}
    starts = [s for s, _, _ in calls]
    out = []
    for a, b in sorted((s, e) for n, dev, s, e in events
                       if n == STEP_SPAN and not dev and w0 <= s < w1):
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
        waited = sum(max(0.0, e - s - base[n]) for s, e, n in calls[lo:hi])
        out.append((b - a - waited) * 1e3)
    return out


def summarize(events, steps):
    """The traced window's reduction: its length, the device's busy
    seconds, every device activity (name, seconds), the launches a step,
    the host's time to issue each step (``host_issue_ms``), and the
    breakdown (the device operations that took most time, and the
    longest idle stretches by the host operation running then)."""
    spans = [(s, e) for n, dev, s, e in events if n == WINDOW_SPAN and not dev]
    if not spans:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = spans[0]
    device = [(n, max(s, w0), min(e, w1)) for n, dev, s, e in events
              if dev and e > w0 and s < w1 and n not in _SPANS
              and not any(k in n for k in _DEVICE_WAITS)]
    busy = _union([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy)
    by_name, counts = defaultdict(float), defaultdict(int)
    for n, s, e in device:
        by_name[short_name(n)] += e - s
        counts[short_name(n)] += 1

    host = sorted((s, e, n) for n, dev, s, e in events
                  if not dev and n != WINDOW_SPAN and n not in _PROFILER_HOST
                  and not n.startswith("cu") and e > s)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host_idle"
        for j in range(i, max(-1, i - 256), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += g1 - g0

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {
        "steps": steps,
        "window_s": w1 - w0,
        "busy_s": busy_s,
        "device_ops": dict(by_name),
        "launches": len(device),
        "launch_counts": dict(counts),
        "host_issue_ms": host_issue_ms(events, w0, w1),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }
