"""Lie groups, robust kernels, small-block inverses and the CUDA kernels."""
