"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk_size=128),
    sliding_window=2048,  # hymba uses SWA in most layers
    source="arXiv:2411.13676",
)
