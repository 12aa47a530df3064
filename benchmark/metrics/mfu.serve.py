"""The whole request's share of the card's peak: one scan of the table,
2·b·m·r operations, over the peak of the table's product precision (bf16
tensor cores for an int8 or bf16 table, float32 for a float32 table),
divided by the window's mean request time."""

from benchmark import yardstick


def read(rec):
    if rec.get("mean_request_s", 0) <= 0:
        return None
    flops = 2.0 * rec["b"] * rec["m"] * rec["r"]
    return 100.0 * flops / yardstick.table_peak(rec["table_dtype"]) \
        / rec["mean_request_s"]
