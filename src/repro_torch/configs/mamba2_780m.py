"""mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
    num_heads=0, num_kv_heads=0, head_dim=64, d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=128),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
