"""Compression of the gradients that cross between pods (QSGD)."""
