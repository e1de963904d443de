"""Device operations launched in the traced slice per engine tick."""


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl["ticks"]:
        return None
    return sl["launches"] / sl["ticks"]
