"""The benchmark's plain references: each model's forward, loss and
training step in float32 PyTorch, written from the published equations.

Nothing here imports the program under test, JAX or the JAX package: the
reference works out again, from the weights and batches the benchmark
makes, everything the program derives from them.
"""
