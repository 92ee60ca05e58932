"""Kernels and numeric policies of the port."""
