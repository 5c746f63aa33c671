"""Llama-4 Scout 17B-active / 16-expert  [hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model 5120, 40 q-heads (GQA kv=8), d_ff 8192 per expert,
vocab 202048, MoE 16 routed experts top-1 + 1 shared expert (early-fusion
text backbone only; multimodal frontend out of scope for this assignment).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, n_shared_experts=1, shared_expert_ff=8192,
    tie_embeddings=False,
)
