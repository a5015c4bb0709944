"""Operators of the port: plain PyTorch ops and the kernel-backed flash
attention."""
