"""deepseek-v3-671b — MoE 256e top-8 + 1 shared, MLA, MTP [arXiv:2412.19437]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
    num_heads=128, num_kv_heads=128, head_dim=128, d_ff=2048,
    vocab_size=129280,
    moe=MoEConfig(num_experts=256, num_shared=1, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    mtp_depth=1,
    source="arXiv:2412.19437",
)
