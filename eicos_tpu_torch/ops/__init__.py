"""Kernels of the port and their plain torch twins."""
