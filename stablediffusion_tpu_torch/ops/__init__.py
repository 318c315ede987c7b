"""Primitive ops and the CUDA attention kernels."""
