"""PyTorch port of the Sherman reproduction (CUDA on an H100).

A second package beside the JAX reference :mod:`repro`, module for module:
``core`` (tree, cache, HOCL, write path, verbs, netsim, the index API),
``kernels`` (hand-written CUDA kernels, each with its plain version) and
``workloads`` (the YCSB engine and CLI).  Entry points run on CUDA unless
the caller asks for the CPU.
"""
