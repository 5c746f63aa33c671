"""Whisper-medium backbone  [arXiv:2212.04356] — encoder-decoder.

24 encoder + 24 decoder layers, d_model 1024, 16 heads (kv=16),
d_ff 4096, vocab 51865.  Conv/mel frontend is a stub: input_specs()
provides precomputed frame embeddings [B, 1500, 1024].
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, n_frames=1500, tie_embeddings=True,
)
