"""Device-busy milliseconds per MU iteration in the traced slice: the
union of the card's operations over the iterations the slice holds."""


def read(rec):
    sl = rec.get("slice")
    if not sl or sl["trace"]["busy_s"] <= 0 or sl["iterations"] <= 0:
        return None
    return sl["trace"]["busy_s"] * 1e3 / sl["iterations"]
