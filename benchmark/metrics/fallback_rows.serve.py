"""Rows per request that the certificate did not certify, over the
window: the rows that took the exact fallback (or its reservoir
escalation), read from the `certified` flags `recommend_certified`
returns."""


def read(rec):
    if rec.get("requests", 0) <= 0:
        return None
    return rec["uncertified_rows"] / rec["requests"]
