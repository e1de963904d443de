"""Share of the traced slice's admissions whose prefill replayed one of the
program's captured CUDA graphs (the ``graph`` attribute, 1 or 0, of its
``serve.prefill.enqueue`` spans), in percent.  A program whose spans carry
no such attribute reads as nothing."""
from portbench.yardstick.spans import named


def read(rec):
    steps = [s.attrs["graph"] for s in named("serve.prefill.enqueue") if "graph" in s.attrs]
    return 100.0 * sum(steps) / len(steps) if steps else None
