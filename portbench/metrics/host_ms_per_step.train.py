"""Host milliseconds to issue one train step, from the traced steps: the
median over them of each step's span less the waits of its CUDA runtime
calls on the card (``trace.host_issue_ms``). Read under the profiler,
which adds its own cost to every host operation."""

import statistics


def read(summary):
    spans = (summary.get("trace") or {}).get("host_issue_ms")
    return statistics.median(spans) if spans else None
