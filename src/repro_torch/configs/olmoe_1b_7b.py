"""olmoe-1b-7b — MoE 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1024, vocab_size=50304,
    moe=MoEConfig(num_experts=64, num_shared=0, top_k=8, d_ff_expert=1024,
                  capacity_factor=1.25),
    source="arXiv:2409.02060",
)
