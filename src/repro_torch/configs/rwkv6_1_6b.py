"""RWKV6 "Finch" 1.6B  [arXiv:2404.05892] — attention-free, data-dependent
decay.  24L, d_model 2048 (32 heads of 64), channel-mix d_ff 7168,
vocab 65536.  Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab=65536, rwkv_head_dim=64,
    tie_embeddings=False, subquadratic=True,
)
