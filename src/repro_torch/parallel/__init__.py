"""Sharding rules of the PyTorch port (:mod:`repro_torch.parallel.sharding`)."""
