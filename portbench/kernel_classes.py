"""Which device operations are PyTorch's or a vendor library's, and which
are the program's own: the one rule ``ops.torch_ms`` and
``kernels.device_ms`` split the device time by.  A kernel whose name
carries none of these marks counts as the program's own, whatever a later
change names it."""
from __future__ import annotations

# PyTorch's kernels live in at::native / at::cuda; cuBLAS names its kernels
# cublas*, *xmma_gemm*, *sgemm*, gemv2*, gemmSN*, gemmk1*; cuFFT vector_fft
# and regular_fft; copies and fills show as Memcpy / Memset
LIBRARY_MARKS = ("at::native", "at::cuda", "at_cuda", "cublas", "cutlass",
                 "xmma", "sgemm", "gemv2", "gemmsn", "gemmk1", "cufft",
                 "vector_fft", "regular_fft", "cudnn", "memcpy", "memset")


def is_library(name: str) -> bool:
    low = name.lower()
    return any(mark in low for mark in LIBRARY_MARKS)
