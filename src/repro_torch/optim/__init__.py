"""Optimizer and gradient compression of the PyTorch port
(:mod:`repro_torch.optim.adamw`, :mod:`repro_torch.optim.compression`)."""
