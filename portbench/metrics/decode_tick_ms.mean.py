"""Mean host-clock milliseconds of one decode step in the traced slice
(``EngineStats.decode_s`` over the ticks that decoded)."""


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl["decode_ticks"]:
        return None
    return 1e3 * sl["decode_s"] / sl["decode_ticks"]
