"""The head and its f32 loss on the training path: the CUDA kernel that
reduces the loss and writes the logits' gradient in place, its plain
version, and the autograd op around the head's products."""
