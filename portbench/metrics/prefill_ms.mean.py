"""Mean host-clock milliseconds of one admission's prefill in the traced
slice (``EngineStats.prefill_s``, which ends in a read of the chosen token)."""


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl["admitted_prompts"]:
        return None
    return 1e3 * sl["prefill_s"] / len(sl["admitted_prompts"])
