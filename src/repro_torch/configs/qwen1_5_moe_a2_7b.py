"""Qwen1.5-MoE-A2.7B as published  [hf:Qwen/Qwen1.5-MoE-A2.7B, config.json,
``model_type`` ``qwen2_moe``].

24 layers, d_model 2048, 16 heads and 16 KV heads of 128 (MHA) with q/k/v
biases, ``rope_theta`` 1e6, ``rms_norm_eps`` 1e-6, untied vocab 151,936.
Every layer is sparse (``decoder_sparse_step`` 1): 60 routed experts of
width 1,408 (``moe_intermediate_size``), top-4 (``num_experts_per_tok``),
the softmax in f32 over the router's logits and the top-4 gates not
renormalised (``norm_topk_prob`` false); one shared expert of width 5,632
(``shared_expert_intermediate_size``) scaled by ``sigmoid(x · w_sg)``,
``w_sg`` [2048, 1].  The router is a Linear in the model's dtype.  No
auxiliary loss (``output_router_logits`` false).  Dispatch is dropless, as
published.

Not in ``ALL_ARCHS``, which mirrors the reference's list:
``qwen2_moe_a2_7b`` is the reference's own (capacity-bounded) entry.  An
expert-parallel rank is ``dataclasses.replace(CONFIG, ep_size=..,
ep_rank=..)``.
"""
from repro_torch.models.common import PortArchConfig

CONFIG = PortArchConfig(
    name="qwen1.5-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=1, shared_expert_ff=5632,
    rope_theta=1_000_000.0, norm_eps=1e-6, tie_embeddings=False,
    norm_topk_prob=False, shared_expert_gate=True, moe_dropless=True,
    moe_router_f32=False, qkv_bias=True,
)
