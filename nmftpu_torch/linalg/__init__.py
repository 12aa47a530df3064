"""Dense linear-algebra update rules and error metrics (plain torch); the
package re-exports those of ``nmftpu.linalg``."""

from nmftpu_torch.linalg.dense import (
    acls_update,
    ahcls_update,
    als_update,
    frobenius_error,
    frobenius_error_sq,
    gdcls_update,
    kl_error,
    mu_update_frobenius,
    mu_update_kl,
    nsnmf_smoothing_matrix,
    rmsd,
)

__all__ = [
    "acls_update",
    "ahcls_update",
    "als_update",
    "frobenius_error",
    "frobenius_error_sq",
    "gdcls_update",
    "kl_error",
    "mu_update_frobenius",
    "mu_update_kl",
    "nsnmf_smoothing_matrix",
    "rmsd",
]
