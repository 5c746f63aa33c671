"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 heads (kv=16), 60 routed experts top-4 with
per-expert d_ff 1408, plus 4 shared experts (shared ff 5632), vocab 151936.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4, shared_expert_ff=5632,
    tie_embeddings=False,
)
