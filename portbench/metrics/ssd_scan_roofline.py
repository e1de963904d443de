"""The SSD scan kernel's share of its roofline in the traced slice: the
least time of the scans the admitted prompts need (the configuration's
``counts`` module lists them, ``ssd_calls``) over the device time of the
kernels matching ``PATTERNS`` (the scan's five passes), in percent.

The least time of one scan is the larger of its operations over the bf16
tensor rate and its bytes over the memory rate.  The operations are the
step recurrence's, two multiply-adds a step, head, channel and state
element (4 S nh hp n); the bytes are x, dt, B and C read once and y written
once at the configuration's element size, and the final state written in
float32.  The bf16 rate and the element size bound the work whatever
implements it, so a faster scan cannot read over 100%.  A configuration
without ``ssd_calls``, or a slice without the kernels, reads as nothing."""
from portbench.yardstick.device import kernel_seconds
from portbench.yardstick.peaks import card_peaks

PATTERNS = ("ssd_",)


def ssd_work(B: int, S: int, nh: int, hp: int, n: int, elem_bytes: int):
    """(FLOPs, bytes) of one scan of x (B, S, nh, hp), dt (B, S, nh) and
    B, C (B, S, n)."""
    flops = 4.0 * B * S * nh * hp * n
    nbytes = elem_bytes * B * S * (2 * nh * hp + nh + 2 * n) + 4 * B * nh * hp * n
    return flops, float(nbytes)


def read(rec):
    sl, counts = rec.get("slice"), rec.get("counts")
    if not sl or counts is None or not hasattr(counts, "ssd_calls") \
            or not rec.get("device_name"):
        return None
    _, seconds = kernel_seconds(sl["by_name"], PATTERNS)
    if seconds <= 0 or not sl["admitted_prompts"]:
        return None
    c = rec["config"]
    es = 2 if c["dtype"] in ("bfloat16", "float16") else 4
    peaks = card_peaks(rec["device_name"])
    bound = 0.0
    for s in sl["admitted_prompts"]:
        for call in counts.ssd_calls(c, s):
            flops, nbytes = ssd_work(*call, es)
            bound += max(flops / peaks.bf16_flops, nbytes / peaks.mem_bytes)
    return 100.0 * bound / seconds
