"""Mean milliseconds of the program's ``serve.decode.enqueue`` spans in the
traced slice: the host launching one decode step, with the device
behind."""
from portbench.yardstick.spans import mean_ms


def read(rec):
    return mean_ms("serve.decode.enqueue")
