"""Kernel #11 under its CG rule (`ell_kl_kernel` in `csrc/ell_rowsums.cu`
with `CgRule`: the sparse term of the iALS systems' product with one
vector a row) against its roofline in the traced slice. The launches the
program counted (`ell_cg`) are half W half-steps' (own n rows, table m)
and half H half-steps' (own m, table n); each is taken at the least time
of #11's work (`yardstick.ell_kl_work`: the sample and the sum, 4·nnz·r),
over the device time of the kernel class `ell_kl`, which holds every
launch of #11 whatever its rule. None where the program counts no such
launch."""

from benchmark import yardstick


def read(rec):
    sl = rec.get("slice")
    if not sl:
        return None
    cls = sl["trace"]["classes"].get("ell_kl")
    launches = sl["launches"].get("ell_cg", 0)
    if not cls or cls["seconds"] <= 0 or launches <= 0:
        return None
    n, m, r, nnz = rec["n"], rec["m"], rec["r"], rec["nnz"]
    pair = sum(yardstick.bound_s(*yardstick.ell_kl_work(own, table, r, nnz),
                                 yardstick.F32_PEAK)[0]
               for own, table in ((n, m), (m, n)))
    return 100.0 * launches / 2 * pair / cls["seconds"]
