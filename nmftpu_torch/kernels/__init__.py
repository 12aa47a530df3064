"""Hand-written CUDA kernels (sources in ``nmftpu_torch/csrc``), each with
its plain torch twin, and their build (``_build``)."""
