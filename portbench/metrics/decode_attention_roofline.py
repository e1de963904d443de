"""The decode attention kernel's share of its roofline in the traced slice:
the least time of the attention the slice's decode steps need, over the
device time of the kernels matching ``PATTERNS``, in percent.

A step attends each slot's query heads to the keys its cache holds: the
program's ``serve.tick`` spans count them (``kv_tokens``, the sum over the
slots of their ``kv_len``), and the ticks that decoded have ``live``.  The
least time of one step is, for each of the configuration's layers, the
larger of its operations (QK^T and PV, 4 H hd a key) over the bf16 tensor
rate and its bytes over the memory rate: the live K and V rows read once,
q read and the output written once.  A program without the counter or the
kernels reads as nothing."""
from portbench.yardstick.device import kernel_seconds
from portbench.yardstick.peaks import card_peaks
from portbench.yardstick.spans import named

PATTERNS = ("decode_attn_",)


def read(rec):
    sl = rec.get("slice")
    if not sl or not rec.get("device_name"):
        return None
    ticks = [s.attrs for s in named("serve.tick")
             if s.attrs.get("live") and "kv_tokens" in s.attrs]
    _, seconds = kernel_seconds(sl["by_name"], PATTERNS)
    if seconds <= 0 or not ticks:
        return None
    c = rec["config"]
    H, KV, layers = c["n_heads"], c["n_kv_heads"], c["n_layers"]
    hd = c["d_model"] // H
    es = 2 if c["dtype"] in ("bfloat16", "float16") else 4
    peaks = card_peaks(rec["device_name"])
    bound = sum(layers * max(4 * H * hd * t["kv_tokens"] / peaks.bf16_flops,
                             es * hd * (2 * KV * t["kv_tokens"] + 2 * H * t["slots"])
                             / peaks.mem_bytes)
                for t in ticks)
    return 100.0 * bound / seconds
