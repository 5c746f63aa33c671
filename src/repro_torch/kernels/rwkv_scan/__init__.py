"""The WKV6 recurrence: the CUDA kernel, its plain version and the
model-layout wrapper."""
