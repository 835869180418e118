"""repro_torch: the HNTL index of the Aperon technical report in PyTorch,
with its scan kernels written by hand in CUDA C++ for Hopper (sm_90a).

It sits beside the JAX package ``repro`` (the reference) and imports
nothing of it, nor JAX.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
from .core import BuildInfo, HNTLConfig, build, int32_safe_qmax, search

__all__ = ["BuildInfo", "HNTLConfig", "build", "int32_safe_qmax", "search"]
