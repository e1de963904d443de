"""Model FLOPs of the prompts admitted in the traced slice (the
configuration's ``counts`` module, from its widths) over the card's bf16
peak times the prefill seconds, in percent."""
from portbench.yardstick.peaks import card_peaks


def read(rec):
    sl, counts = rec.get("slice"), rec.get("counts")
    if not sl or counts is None or not sl["admitted_prompts"] or not rec.get("device_name") \
            or sl["prefill_s"] <= 0:
        return None
    flops = sum(counts.prefill_flops(rec["config"], s) for s in sl["admitted_prompts"])
    return 100.0 * flops / (card_peaks(rec["device_name"]).bf16_flops * sl["prefill_s"])
