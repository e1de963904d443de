"""Mean milliseconds a request admitted in the traced slice waited in the
engine's queue: ``queued_s`` of the program's ``serve.admit`` spans, from
``ServeEngine.submit`` to the start of the request's prefill."""
from portbench.yardstick.spans import named


def read(rec):
    waits = [s.attrs["queued_s"] for s in named("serve.admit")
             if s.attrs.get("queued_s") is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None
