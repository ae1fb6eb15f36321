"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors ``repro``'s module layout (``configs``, ``models``, ``kernels``,
``serving``, ``launch``) and imports nothing of it, nor JAX.  Attention
on the paged serving path runs in hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use; CPU tensors take the
kernels' plain PyTorch versions.
"""
