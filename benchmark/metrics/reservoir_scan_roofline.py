"""Kernel #8 (the reservoir scan, `csrc/mips_reservoir.cu`, with its
merge) against its roofline in the traced slice. Each request scans the
whole table once for its batch; scans beyond one a request (the
certificate's escalation over a few uncertified rows) are counted at the
least time of any scan, the table read once. Over the kernel's device
time in the trace."""

from benchmark import yardstick


def read(rec):
    sl = rec.get("slice")
    if not sl or rec.get("method") != "reservoir":
        return None
    cls = sl["trace"]["classes"].get("reservoir_scan")
    scans = sl["launches"][0]
    if not cls or cls["seconds"] <= 0 or scans < sl["requests"]:
        return None
    b, m, r, t = rec["b"], rec["m"], rec["r"], rec["table_dtype"]
    main = yardstick.reservoir_scan_bound(b, m, r, t, rec["slots"])
    extra = yardstick.reservoir_scan_bound(0, m, r, t, 0)
    least = sl["requests"] * main + (scans - sl["requests"]) * extra
    return 100.0 * least / cls["seconds"]
