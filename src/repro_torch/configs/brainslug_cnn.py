"""The paper's own evaluation domain: VGG-style CNNs with
<MaxPool, BatchNorm, ReLU> stacks (paper §5.1 synthetic benchmark and
§5.2 TorchVision families).  Used by the faithful-reproduction benchmarks,
not part of the 10 assigned LM cells."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="brainslug-cnn", family="cnn",
    n_layers=8, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=10,
    source="[paper §5; faithful]",
)
