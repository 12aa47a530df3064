"""Kernel #11 (the ELL KL numerator, `ell_kl_kernel` in
`csrc/ell_rowsums.cu`) against its roofline in the traced slice. The
launches the program counted alternate between the W half-step (own W,
table H) and the H half-step (own H, table W); each half is taken at the
least time its work needs (`yardstick.ell_kl_work`), over the kernel's
device time in the trace."""

from benchmark import yardstick


def read(rec):
    sl = rec.get("slice")
    if not sl:
        return None
    cls = sl["trace"]["classes"].get("ell_kl")
    launches = sl["launches"].get("ell_kl", 0)
    if not cls or cls["seconds"] <= 0 or launches <= 0:
        return None
    n, m, r, nnz = rec["n"], rec["m"], rec["r"], rec["nnz"]
    pair = sum(yardstick.bound_s(*yardstick.ell_kl_work(own, table, r, nnz),
                                 yardstick.F32_PEAK)[0]
               for own, table in ((n, m), (m, n)))
    return 100.0 * launches / 2 * pair / cls["seconds"]
