"""Kernel build/load (``build``) and the wrappers of ``csrc/`` kernels."""
