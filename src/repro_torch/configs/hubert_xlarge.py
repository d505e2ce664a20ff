"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).
Frontend (conv feature extractor) is a stub: input_specs supplies frame
embeddings. [arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, norm="layer", act="gelu",
    is_encoder=True, frontend="audio_frames", frontend_dim=512,
    source="[arXiv:2106.07447; unverified]",
)
