"""Output tokens emitted in the window over the window's seconds."""


def read(rec):
    if not rec.get("window_s") or "output_tokens" not in rec:
        return None
    return rec["output_tokens"] / rec["window_s"]
