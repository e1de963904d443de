"""Share of the traced slice's wall time in which no operation ran on the
device, in percent.  Read under every name ``device_idle_pct.<cells>``:
one quantity, named apart for each end-to-end metric it moves."""


def read(rec):
    sl = rec.get("slice")
    if not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
