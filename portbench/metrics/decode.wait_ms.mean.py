"""Mean milliseconds of the program's ``serve.decode.wait`` spans in the
traced slice: the host blocked on the device for a decode step's
tokens."""
from portbench.yardstick.spans import mean_ms


def read(rec):
    return mean_ms("serve.decode.wait")
