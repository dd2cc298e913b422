"""Host milliseconds to issue one chain step from an idle device: the
median of the benchmark's spans around the step's call, each after a
synchronize and with none inside. (A chain step's few hundred launches
never fill the launch queue; ``host_ms_per_step.train.py`` reads the train
step's from the trace.)"""

import statistics


def read(summary):
    spans = summary.get("host_span_ms")
    return statistics.median(spans) if spans else None
