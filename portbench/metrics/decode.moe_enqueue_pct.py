"""Share of the decode steps' enqueue time (the program's
``serve.decode.enqueue`` spans in the traced slice) spent inside its
``moe.*`` spans, the MoE blocks' launches, in percent."""
from portbench.yardstick.spans import share_pct


def read(rec):
    return share_pct("serve.decode.enqueue", "moe.")
