"""zamba2-7b — mamba2 backbone + shared attention block every 14th layer.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    attn_layer_period=14,
    source="[arXiv:2411.15242; unverified]",
)
