"""internvl2-26b — VLM: InternViT (stub) + InternLM2 backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92553,
    num_patches=256, rope_theta=1e6,
    source="arXiv:2404.16821",
)
