"""What the readers of the program's own spans and counters share.

The program (``sr3_tpu_torch.utils.profiler``) keeps them in the memory of
the run's process, where the readers run once the run is done: spans only
from the traced steps (it records them only under ``torch.profiler``),
counts over the whole run. Every function here gives None where the
program has no such registry (an older program), recorded no such span,
or timed one on no device (a CPU run)."""


def registry():
    """The program's profiler module, or None where it keeps no spans and
    counters."""
    try:
        from sr3_tpu_torch.utils import profiler
    except ImportError:
        return None
    if not (callable(getattr(profiler, "spans", None))
            and callable(getattr(profiler, "counts", None))):
        return None
    return profiler


def spans_named(name, under=None):
    """The recorded spans called ``name``, outermost only (none inside
    another of that name), and with ``under`` only those with an ancestor
    called ``under``; None without a registry."""
    prof = registry()
    if prof is None:
        return None
    recorded = prof.spans()
    by_id = {s.id: s for s in recorded}

    def ancestors(s):
        while s.parent in by_id:
            s = by_id[s.parent]
            yield s.name

    return [s for s in recorded if s.name == name
            and name not in ancestors(s)
            and (under is None or under in ancestors(s))]


def device_ms(name, under=None):
    """The summed device ms of ``spans_named(name, under)``; None where
    there is none or one has no device time."""
    found = spans_named(name, under)
    if not found:
        return None
    times = [s.device_ms for s in found]
    return None if any(t is None for t in times) else sum(times)


def per_step(name, step):
    """``device_ms(name)`` over the count of ``step`` spans."""
    steps, total = spans_named(step), device_ms(name)
    return None if not steps or total is None else total / len(steps)
