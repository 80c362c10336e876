"""whisper-large-v3 — enc-dec audio; mel+conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_seq=1500,
    source="arXiv:2212.04356",
)
