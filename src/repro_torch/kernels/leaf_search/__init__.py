"""Leaf search: the CUDA kernel, its plain version and the pool wrapper."""
