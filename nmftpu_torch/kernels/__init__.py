"""Hand-written CUDA kernels (sources in ``nmftpu_torch/csrc``), each with
its plain torch twin, and their build (``_build``). Importing a kernel
module builds nothing: nvcc runs at a wrapper's first CUDA launch."""

from nmftpu_torch.kernels import dense_mu

__all__ = ["dense_mu", "quantized", "sparse_ell_kernel"]


def __getattr__(name):
    if name in ("quantized", "sparse_ell_kernel"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
