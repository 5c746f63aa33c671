"""The grouped matrix product over variable-sized expert groups of sorted
rows, for the dropless MoE dispatch: the Triton kernels, their plain
version, and the autograd op."""
