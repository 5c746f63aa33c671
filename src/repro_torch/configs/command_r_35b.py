"""Cohere Command-R 35B  [hf:CohereForAI/c4ai-command-r-v01].

40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000,
no biases, tied embeddings.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000, tie_embeddings=True,
)
