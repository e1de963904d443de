"""Mean milliseconds of the program's ``serve.prefill.enqueue`` spans in the
traced slice: the host launching one admission's prefill and writing its
slot, with the device behind."""
from portbench.yardstick.spans import mean_ms


def read(rec):
    return mean_ms("serve.prefill.enqueue")
