"""The whole step's share of the card's peak: the operations one MU
iteration needs, counted from the shapes (`yardstick.
mu_flops_per_iteration`), over the configuration's peak (float32 on the
CUDA cores, TF32 off), divided by the window's time per iteration
outside the traced slice."""


def read(rec):
    if rec.get("iteration_s", 0) <= 0:
        return None
    return 100.0 * rec["flops_per_iteration"] / rec["peak"] \
        / rec["iteration_s"]
