"""RecurrentGemma-2B (Griffin)  [arXiv:2402.19427].

26L in (rec, rec, local-attn) super-blocks, d_model 2560, 10 heads
(MQA kv=1), d_ff 7680, vocab 256000, window 2048, lru_width 2560.
Sub-quadratic (bounded window): runs the long_500k cell.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, window=2048, rg_lru_width=2560,
    conv_width=4, tie_embeddings=True, subquadratic=True,
)
