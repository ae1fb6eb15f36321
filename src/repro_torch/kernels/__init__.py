"""Attention kernels: CUDA sources in ``csrc/``, their wrappers, plain versions and the device dispatch."""
