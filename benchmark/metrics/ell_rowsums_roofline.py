"""Kernel #10 (the ELL segment SpMM, `csrc/ell_rowsums.cu`) against its
roofline in the traced slice: the launches the program counted, each at
the least time its work needs (`yardstick.ell_spmm_work`, one product of
V or Vᵀ with a float32 factor), over the kernel's device time in the
trace."""

from benchmark import yardstick


def read(rec):
    sl = rec.get("slice")
    if not sl:
        return None
    cls = sl["trace"]["classes"].get("ell_rowsums")
    launches = sl["launches"].get("ell_rowsums", 0)
    if not cls or cls["seconds"] <= 0 or launches <= 0:
        return None
    flops, nbytes = yardstick.ell_spmm_work(rec["n"], rec["m"], rec["r"],
                                            rec["nnz"])
    least = yardstick.bound_s(flops, nbytes, yardstick.F32_PEAK)[0]
    return 100.0 * launches * least / cls["seconds"]
