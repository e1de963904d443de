"""The flash kernel's share of its roofline in the traced slice: the least
time of the attention the admitted prompts need (the configuration's
``counts`` module lists the calls; causal pairs once, q/k/v read and the
output written once) over the device time of the kernels matching
``PATTERNS``, in percent."""
from portbench.yardstick.bounds import attention_bound_s
from portbench.yardstick.device import kernel_seconds
from portbench.yardstick.peaks import card_peaks

PATTERNS = ("flash_fwd",)


def read(rec):
    sl, counts = rec.get("slice"), rec.get("counts")
    if not sl or counts is None or not rec.get("device_name"):
        return None
    _, seconds = kernel_seconds(sl["by_name"], PATTERNS)
    if seconds <= 0 or not sl["admitted_prompts"]:
        return None
    c = rec["config"]
    es = 2 if c["dtype"] in ("bfloat16", "float16") else 4
    peaks = card_peaks(rec["device_name"])
    bound = sum(attention_bound_s(*call, es, peaks)
                for s in sl["admitted_prompts"] for call in counts.attention_calls(c, s))
    return 100.0 * bound / seconds
