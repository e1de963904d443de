"""Share of the decode steps' enqueue time (the program's
``serve.decode.enqueue`` spans in the traced slice) spent inside its
``layer.mamba`` spans, the mamba2 mixers' launches, in percent."""
from portbench.yardstick.spans import share_pct


def read(rec):
    return share_pct("serve.decode.enqueue", "layer.mamba")
