"""paligemma-3b — SigLIP (stub) + gemma backbone VLM.
[arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=257216, act="gelu", tie_embeddings=True,
    frontend="vision_patches", n_prefix_tokens=256, frontend_dim=1152,
    source="[arXiv:2407.07726; hf]",
)
