"""llama4-maverick-400b-a17b — 128-expert top-1 MoE with shared expert,
MoE on alternating layers (dense otherwise), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048,
    n_experts=128, top_k=1, moe_layer_period=2, shared_expert_ff=8192,
    capacity_factor=1.25,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
