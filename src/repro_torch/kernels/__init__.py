"""Kernel layer of the port: the seam (ops), the CUDA kernels and their plain versions."""
