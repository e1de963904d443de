"""Mean milliseconds of the program's ``serve.prefill.wait`` spans in the
traced slice: the host blocked on the device for an admission's first
token."""
from portbench.yardstick.spans import mean_ms


def read(rec):
    return mean_ms("serve.prefill.wait")
