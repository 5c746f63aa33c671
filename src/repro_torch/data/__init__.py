"""Synthetic LM data of the PyTorch port (:mod:`repro_torch.data.tokens`)."""
