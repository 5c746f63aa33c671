"""InternVL2-1B  [arXiv:2404.16821] — InternViT frontend + Qwen2-0.5B LM.

LM backbone: 24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864,
vocab 151655.  ViT frontend is a stub: input_specs() provides precomputed
patch embeddings [B, 256, 896] prepended to the text sequence.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, n_patches=256, tie_embeddings=True,
)
