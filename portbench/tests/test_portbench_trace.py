"""The trace's reduction: the host's time to issue a step leaves out what
its runtime calls waited on the card, and the readers find it by the
metric's full name."""

import pytest

from portbench import cells, trace

US = 1e-6


def _events(launch_us, sync_us=0.0, step=(0.0, 0.5)):
    """A window of one step span holding back-to-back launches of the
    given microseconds, then an optional synchronize."""
    ev = [(trace.WINDOW_SPAN, False, 0.0, 1.0),
          (trace.STEP_SPAN, False, step[0], step[1])]
    t = step[0] + 1e-3
    for d in launch_us:
        ev.append(("cudaLaunchKernel", False, t, t + d * US))
        ev.append(("some_kernel", True, t, t + 1e-6))
        t += d * US + 1 * US
    if sync_us:
        ev.append(("cudaStreamSynchronize", False, t, t + sync_us * US))
    return ev


def test_unblocked_launches_are_counted_whole():
    ms = trace.host_issue_ms(_events([5.0] * 200), 0.0, 1.0)
    assert ms == [pytest.approx(500.0)]


@pytest.mark.parametrize("free", [64, 128, 300])
def test_launches_that_wait_for_the_queue_are_taken_out(free):
    # the queue fills after `free` launches; each later one waits 1 ms
    launches = [5.0] * free + [1000.0] * 400
    ms = trace.host_issue_ms(_events(launches, sync_us=20000.0), 0.0, 1.0)
    waited = 400 * (1000.0 - 5.0) * US + 20000.0 * US
    assert ms == [pytest.approx((0.5 - waited) * 1e3)]


def test_only_calls_inside_a_step_count_against_it():
    ev = _events([5.0] * 10, step=(0.0, 0.5))
    ev.append((trace.STEP_SPAN, False, 0.6, 0.7))
    # a call that waits 50 ms between the steps, and one inside the second
    ev.append(("cudaStreamSynchronize", False, 0.52, 0.57))
    ev.append(("cudaLaunchKernel", False, 0.65, 0.65 + 5 * US))
    ms = trace.host_issue_ms(ev, 0.0, 1.0)
    assert ms == [pytest.approx(500.0), pytest.approx(100.0)]


def test_the_train_reader_reads_the_trace_and_the_chain_reader_spans():
    summary = {"trace": {"host_issue_ms": [3.0, 1.0, 2.0]},
               "host_span_ms": [7.0, 9.0, 8.0]}
    assert cells.reader("host_ms_per_step.train")(summary) == 2.0
    assert cells.reader("host_ms_per_step.sample")(summary) == 8.0
    assert cells.reader("host_ms_per_step.train")({"trace": {}}) is None
