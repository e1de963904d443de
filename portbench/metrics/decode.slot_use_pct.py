"""Slots decoding for a request over slots in the pool, summed over the
traced slice's decoding ticks (the ``live`` and ``slots`` counters of the
program's ``serve.tick`` spans), in percent."""
from portbench.yardstick.spans import named


def read(rec):
    ticks = [s.attrs for s in named("serve.tick") if s.attrs.get("live")]
    slots = sum(a["slots"] for a in ticks)
    return 100.0 * sum(a["live"] for a in ticks) / slots if slots else None
